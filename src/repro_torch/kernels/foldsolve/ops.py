"""Public wrapper for foldsolve, with the λ→0 jitter retry.

The kernel's pivot-free Gauss–Jordan is exact for the SPD, well-conditioned
A = I − H_Te that ridge-regularised plans produce (λ > 0 keeps H's spectrum
inside [0, 1)). As λ → 0 in the P ≥ N regime, H_Te → I and A degenerates;
the elimination then divides by vanishing pivots and the solve degrades or
overflows. The wrapper solves once, measures each fold's residual
‖A ė − ê‖_∞ against √ε·(1 + ‖ê‖_∞) (non-finite output counts as failing),
and re-solves the failing folds against the Tikhonov-shifted A + ε_k I with
ε_k = :func:`fold_jitter`.

On CUDA the retry is a second launch of the same kernel with the per-fold
shift and ``bad`` flags: blocks of healthy folds return at once, so no host
synchronisation decides whether to retry. On the CPU the plain version
re-solves the bad folds only. Either way a healthy fold keeps its first
solve, which is what the reference's retry recomputes for it bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.foldsolve.foldsolve import foldsolve_cuda
from repro_torch.kernels.foldsolve.ref import foldsolve_ref

__all__ = ["foldsolve", "fold_jitter", "fold_residual_bad", "jitter_retry"]


def _residual_tol(dtype: torch.dtype) -> float:
    """√ε acceptance threshold: far above a healthy solve's ~ε·m residual,
    far below the O(1) residual of a degenerate pivot-free elimination."""
    return float(torch.finfo(dtype).eps) ** 0.5


def _eye_minus(h_te: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(h_te.shape[-1], dtype=h_te.dtype, device=h_te.device)
    return eye - h_te


def fold_jitter(h_te: torch.Tensor) -> torch.Tensor:
    """Per-fold Tikhonov shift ε_k = √ε·(1 + ‖I − H_Te[k]‖_max)."""
    a = _eye_minus(h_te)
    return _residual_tol(h_te.dtype) * (1.0 + a.abs().amax(dim=(1, 2)))


def fold_residual_bad(h_te: torch.Tensor, t: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(K,) bool: folds whose solve t of (I − H_Te) t = e failed the
    residual check (or produced non-finite values)."""
    r = torch.bmm(_eye_minus(h_te), t) - e
    scale = 1.0 + e.abs().amax(dim=(1, 2))
    finite = torch.isfinite(t).all(dim=2).all(dim=1)
    # NaN propagates through amax; comparisons with NaN are False, so the
    # finiteness term (not the residual term) must catch that case.
    resid_ok = r.abs().amax(dim=(1, 2)) <= _residual_tol(e.dtype) * scale
    return ~(finite & resid_ok)


def jitter_retry(h_te: torch.Tensor, e: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Re-solve the folds of ``t`` that fail the residual check against
    A + ε_k I; returns ``t`` with those folds replaced."""
    bad = fold_residual_bad(h_te, t, e)
    shift = torch.where(bad, fold_jitter(h_te), torch.zeros((), dtype=h_te.dtype,
                                                             device=h_te.device))
    if h_te.device.type != "cpu":
        return foldsolve_cuda(h_te, e, shift=shift, bad=bad, out=t)
    if bool(bad.any()):
        eye = torch.eye(h_te.shape[-1], dtype=h_te.dtype)
        t = t.clone()
        t[bad] = foldsolve_ref(h_te[bad] - shift[bad, None, None] * eye, e[bad])
    return t


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
        out = foldsolve_ref(h_te, e)
    else:
        out = foldsolve_cuda(h_te, e)
    if jitter == "auto":
        out = jitter_retry(h_te, e, out)
    return out[..., 0] if squeeze else out
