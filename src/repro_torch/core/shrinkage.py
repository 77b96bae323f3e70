"""Shrinkage regularisation and its ridge equivalence (paper §2.6.2).

Shrinkage replaces S_w by (1−λ)S_w + λνI with ν = trace(S_w)/P. As shown
in the paper, this breaks the low-rank update structure (ν changes per
training fold), so the analytical approach supports it only through the
conversion Eq. (18): given λ_shrink, the ridge parameter

    λ_ridge = λ_shrink / (1 − λ_shrink) · ν

produces a *proportional* regularised scatter matrix and therefore an
identical classifier (decision values scale; labels/AUC unchanged).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gram.ops import centered_gram

__all__ = ["trace_scaling", "shrink_to_ridge", "ledoit_wolf_lambda"]


def trace_scaling(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ν = trace(S_w)/P (binary labels ±1) or trace of total scatter if y=None."""
    if y is None:
        xc = x - x.mean(dim=0, keepdim=True)
        return (xc * xc).sum() / x.shape[1]
    pos = (y > 0).to(x.dtype)
    neg = 1.0 - pos
    m1 = (pos @ x) / torch.clamp(pos.sum(), min=1.0)
    m2 = (neg @ x) / torch.clamp(neg.sum(), min=1.0)
    xc = x - torch.where((y > 0)[:, None], m1[None], m2[None])
    return (xc * xc).sum() / x.shape[1]


def shrink_to_ridge(lam_shrink, nu):
    """Eq. (18): λ_ridge = λ_shrink/(1−λ_shrink) · ν."""
    return lam_shrink / (1.0 - lam_shrink) * nu


def ledoit_wolf_lambda(x: torch.Tensor) -> torch.Tensor:
    """Ledoit-Wolf optimal shrinkage intensity for the covariance of x.

    Convenience for choosing λ_shrink automatically (Blankertz et al. 2011
    practice referenced by the paper); combined with :func:`shrink_to_ridge`
    it gives a data-driven ridge λ usable by the analytical approach.

    For P > N the P×P covariance S = X_cᵀX_c/n is never formed (23 GB in
    f32 at P = 76,000): its traces come from the N×N centered Gram G_c
    (the ``gram`` kernel on a CUDA tensor), since tr(S) = tr(G_c)/n,
    ‖S‖²_F = ‖G_c‖²_F/n² and the row norms ‖xᵢ‖² are diag(G_c). For
    P ≤ N the P×P form is kept: there S may lie close to μI, and
    ‖S‖²_F − μ²P would cancel.
    """
    n, p = x.shape
    if p > n:
        g = centered_gram(x)
        s_sq = (g * g).sum() / n**2                       # ‖S‖²_F
        mu = torch.trace(g) / n / p
        d2 = s_sq - mu * mu * p                           # ‖S − μI‖²_F
        b2 = (torch.diagonal(g) ** 2).sum() / n**2 - s_sq / n
    else:
        xc = x - x.mean(dim=0, keepdim=True)
        s = xc.T @ xc / n
        mu = torch.trace(s) / p
        d2 = ((s - mu * torch.eye(p, dtype=x.dtype, device=x.device)) ** 2).sum()
        # (1/n²)Σᵢ‖xᵢxᵢᵀ − S‖²_F = (Σᵢ‖xᵢ‖⁴)/n² − ‖S‖²_F/n  (no N×P×P temporary)
        b2 = ((xc * xc).sum(dim=1) ** 2).sum() / n**2 - (s * s).sum() / n
    b2 = torch.minimum(torch.clamp(b2, min=0.0), d2)
    return torch.clamp(b2 / torch.clamp(d2, min=1e-30), 0.0, 1.0)
