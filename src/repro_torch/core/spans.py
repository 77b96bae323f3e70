"""repro_torch.core.spans — the active trace, and the span hook core code opens on it.

The serving stack's tracer (:mod:`repro_torch.serve.trace`) keeps the
trace of the request being served in :data:`CURRENT`, a
``contextvars.ContextVar``. The variable lives here, below both ``core``
and ``serve``, so the analysis functions can time their own stages
without importing ``serve`` (whose package imports the engine, which
imports ``core``)::

    from repro_torch.core.spans import span

    with span("fingerprint"):
        digest = fingerprint(x)

With no active trace, :func:`span` returns a shared null context manager:
the call costs one ``ContextVar.get``. With one, it opens a span on it,
nested under whichever span is open. It reads the host clock only: it
never waits for the device, so a span measures what the host spent there,
launches and any waits the work makes by itself. The port's reprolint
checks the literal of every ``span("...")`` call against
``serve.trace.STAGES`` (RL002). Core calls the hook by its bare name: the
reference package's reprolint scans this tree too, against its own ten
stages, and reads only attribute calls (``tracer.span("...")``).

Standard library only.
"""

from __future__ import annotations

import contextlib
import contextvars

__all__ = ["CURRENT", "NULL", "span"]

#: The active trace (a ``serve.trace.Trace``), or None.
CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_serve_trace", default=None)

#: The context manager every span hook returns when no trace is active.
NULL = contextlib.nullcontext()


def span(name: str):
    """Time stage ``name`` on the active trace (null CM when none)."""
    trace = CURRENT.get()
    return NULL if trace is None else trace.span(name)
