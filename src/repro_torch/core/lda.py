"""Binary LDA: direct (scatter-matrix) form and the regression form.

These are the paper's *standard approach* comparators: the classifier is
retrained from scratch on every training fold (O(KNP² + KP³), Table 1).
Folds run one after another, so a timing reflects the standard approach's
true cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.folds import Folds

__all__ = [
    "BinaryLDA",
    "fit_binary",
    "fit_binary_regression",
    "decision_values",
    "standard_cv_binary",
]


class BinaryLDA(NamedTuple):
    w: torch.Tensor    # (P,)
    b: torch.Tensor    # ()


def _chol_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve a SPD system by Cholesky; rhs (P,) or (P, Q)."""
    vec = rhs.ndim == 1
    out = torch.cholesky_solve(rhs[:, None] if vec else rhs, torch.linalg.cholesky(a))
    return out[:, 0] if vec else out


def scatter_within(x: torch.Tensor, y: torch.Tensor):
    """Within-class scatter S_w and class means (labels ±1), Eq. (1)."""
    pos = (y > 0).to(x.dtype)
    neg = 1.0 - pos
    n1 = torch.clamp(pos.sum(), min=1.0)
    n2 = torch.clamp(neg.sum(), min=1.0)
    m1 = (pos @ x) / n1
    m2 = (neg @ x) / n2
    xc = x - torch.where((y > 0)[:, None], m1[None, :], m2[None, :])
    return xc.T @ xc, m1, m2


def fit_binary(x: torch.Tensor, y: torch.Tensor, lam: float = 0.0) -> BinaryLDA:
    """w = (S_w + λI)⁻¹ (m₁ − m₂); b = −wᵀ(m₁ + m₂)/2  (Eqs. 3, 4, 16)."""
    sw, m1, m2 = scatter_within(x, y)
    p = x.shape[1]
    w = _chol_solve(sw + lam * torch.eye(p, dtype=x.dtype, device=x.device), m1 - m2)
    return BinaryLDA(w, -0.5 * torch.dot(w, m1 + m2))


def fit_binary_regression(x: torch.Tensor, y: torch.Tensor, lam: float = 0.0):
    """β̂ = (X̃ᵀX̃ + λI₀)⁻¹ X̃ᵀ y  (Eq. 17) — the regression form of LDA.

    Returns (w, b_LR). Its *decision values* are exactly what the
    analytical CV approach reproduces fold-wise.
    """
    n = x.shape[0]
    xa = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
    p1 = xa.shape[1]
    i0 = torch.eye(p1, dtype=x.dtype, device=x.device)
    i0[p1 - 1, p1 - 1] = 0.0
    beta = _chol_solve(xa.T @ xa + lam * i0, xa.T @ y.to(x.dtype))
    return beta[:-1], beta[-1]


def decision_values(x: torch.Tensor, model: BinaryLDA) -> torch.Tensor:
    return x @ model.w + model.b


def standard_cv_binary(x: torch.Tensor, y: torch.Tensor, folds: Folds,
                       lam: float = 0.0, form: str = "lda"):
    """Standard-approach k-fold CV: retrain on every training fold.

    form="lda"        direct scatter-matrix LDA (paper's standard baseline)
    form="regression" regression-form ridge fit — decision values that must
                      match the analytical approach *exactly*.

    Returns (dvals_te, y_te) of shape (K, m).
    """
    if form not in ("lda", "regression"):
        raise ValueError(f"unknown form {form!r}")
    y = y.to(x.dtype)
    dvals = []
    for te, tr in zip(folds.te_idx, folds.tr_idx):
        x_tr, y_tr, x_te = x[tr], y[tr], x[te]
        if form == "lda":
            dvals.append(decision_values(x_te, fit_binary(x_tr, y_tr, lam)))
        else:
            w, b = fit_binary_regression(x_tr, y_tr, lam)
            dvals.append(x_te @ w + b)
    return torch.stack(dvals), y[folds.te_idx]
