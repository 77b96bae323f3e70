"""Public wrapper for foldsolve, with the λ→0 jitter retry.

The kernel's pivot-free Gauss–Jordan is exact for the SPD, well-conditioned
A = I − H_Te that ridge-regularised plans produce (λ > 0 keeps H's spectrum
inside [0, 1)). As λ → 0 in the P ≥ N regime, H_Te → I and A degenerates;
the elimination then divides by vanishing pivots and the solve degrades or
overflows. ``jitter="auto"`` solves once, measures each fold's residual
‖A ė − ê‖_∞ against √ε·(1 + ‖ê‖_∞) (non-finite output counts as failing),
and solves each failing fold again, whole, against the Tikhonov-shifted
A + ε_k I with ε_k = :func:`fold_jitter`; a healthy fold keeps its first
solve, bit for bit, as under the reference's ``lax.cond``.

On CUDA all of that is one launch of the kernel (``check=True``): the
blocks of a fold compute its residual, agree on the decision and re-solve
it in place, with no host synchronisation and no other op. On the CPU the
plain version runs the same steps (``ref.foldsolve_checked_ref``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.foldsolve.foldsolve import foldsolve_cuda
from repro_torch.kernels.foldsolve.ref import (fold_jitter, fold_residual_bad,
                                               foldsolve_checked_ref, foldsolve_ref)

__all__ = ["foldsolve", "fold_jitter", "fold_residual_bad"]


def foldsolve(h_te: torch.Tensor, e_te: torch.Tensor, *,
              jitter: Optional[str] = "auto") -> torch.Tensor:
    """ė_Te = (I − H_Te)⁻¹ ê_Te for all folds at once.

    h_te: (K, m, m) diagonal fold blocks of the hat matrix.
    e_te: (K, m) or (K, m, B) full-fit errors (B = permutation batch).
    jitter: "auto" (default) enables the residual-checked retry against the
        shifted A + ε_k I; None disables it (raw solve).
    """
    if jitter not in ("auto", None):
        raise ValueError(f"jitter must be 'auto' or None, got {jitter!r}")
    squeeze = e_te.ndim == 2
    e = e_te[..., None] if squeeze else e_te
    if h_te.device.type == "cpu":
        out = foldsolve_checked_ref(h_te, e) if jitter else foldsolve_ref(h_te, e)
    else:
        out, _ = foldsolve_cuda(h_te, e, check=jitter == "auto")
    return out[..., 0] if squeeze else out
