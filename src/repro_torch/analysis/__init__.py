"""repro_torch.analysis — ``reprolint`` for the PyTorch port.

The counterpart of ``repro.analysis``: an AST-based checker of the
invariants the port's serving stack rests on. Host paths must not build
or assemble tensors with eager ``torch`` ops piece by piece, nor block on
the device with ``.item()``; batching and trace code must use monotonic
clocks; span names must come from the fixed
:data:`repro_torch.serve.trace.STAGES` vocabulary; metric call sites must
match the central :data:`repro_torch.serve.obs.METRICS` declarations;
lock-guarded attributes (``_GUARDED_BY``) may only be mutated under their
lock; and the fastcv update lineage must stay float64 (arXiv 2401.13185).

Stdlib only: it imports neither torch nor the code it checks, so the
checker can never be broken by that code.

Usage::

    python -m repro_torch.analysis                       # the port's tree
    python -m repro_torch.analysis --json src/repro_torch  # machine output

Rules
-----
==========  ===========================================================
RL001       host hygiene: no eager ``torch`` assembly, no ``.item()`` and
            no ``time.time()`` in declared host-path / monotonic-time
            regions
RL002       trace-stage vocabulary: span/stage literals must be STAGES
RL003       metrics discipline: names + label keys must match METRICS;
            label values must come from bounded sources
RL004       lock discipline: ``_GUARDED_BY`` attrs mutate under lock
RL005       host-float64 policy: no sub-float64 dtypes or casts in
            declared host-float64 regions (fastcv update lineage)
RL000       a ``reprolint: ignore`` suppression without a justification
==========  ===========================================================

Suppression syntax (the justification is *mandatory*)::

    x = torch.cat(parts)  # reprolint: ignore[RL001] -- parts already on the card

Scope declarations are in-file pragmas, so a module (or fixture) opts
itself in and the checker needs no path configuration::

    # reprolint: host-path        (module- or function-scoped)
    # reprolint: monotonic-time   (as above)
    # reprolint: host-float64     (as above)
"""

from repro_torch.analysis.core import (  # noqa: F401
    BAD_SUPPRESSION,
    Finding,
    all_rules,
    load_metrics,
    load_stages,
    render_human,
    render_json,
    run,
)
