"""Linear / ridge regression: standard and analytical cross-validation.

The paper (§2.4, §4.3): "If the vector of class labels is replaced by a
vector of continuous responses, then all equations and results apply
equally." The analytical machinery is shared with binary LDA via
``repro_torch.core.fastcv``; this module adds the regression-flavoured API
and the standard retrain-per-fold baseline.
"""

from __future__ import annotations

import torch

from repro_torch.core import fastcv
from repro_torch.core.folds import Folds
from repro_torch.core.lda import _chol_solve

__all__ = ["fit_ridge", "predict", "standard_cv", "analytical_cv"]


def fit_ridge(x: torch.Tensor, y: torch.Tensor, lam: float = 0.0):
    """β̂ = (X̃ᵀX̃ + λI₀)⁻¹ X̃ᵀ y with unpenalised intercept (Eq. 17).

    For P >= N the dual form is used: with centered data,
    w = X_cᵀ (G_c + λI)⁻¹ y_c and b = ȳ − x̄ᵀw (min-norm ridge solution).
    Returns (w (P, ...), b (...)). ``y`` may be (N,) or (N, Q).
    """
    n, p = x.shape
    y = y.to(x.dtype)
    if p < n:
        xa = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
        i0 = torch.eye(p + 1, dtype=x.dtype, device=x.device)
        i0[p, p] = 0.0
        beta = _chol_solve(xa.T @ xa + lam * i0, xa.T @ y)
        return beta[:-1], beta[-1]
    if lam <= 0:
        raise ValueError("P >= N requires lam > 0")
    mu = x.mean(dim=0, keepdim=True)
    xc = x - mu
    yc = y - y.mean(dim=0, keepdim=True) if y.ndim > 1 else y - y.mean()
    g = xc @ xc.T + lam * torch.eye(n, dtype=x.dtype, device=x.device)
    w = xc.T @ _chol_solve(g, yc)
    b = y.mean(dim=0) - mu[0] @ w
    return w, b


def predict(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w + b


def standard_cv(x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float = 0.0):
    """Retrain-per-fold ridge regression CV (standard approach baseline)."""
    y = y.to(x.dtype)
    preds = []
    for te, tr in zip(folds.te_idx, folds.tr_idx):
        w, b = fit_ridge(x[tr], y[tr], lam)
        preds.append(x[te] @ w + b)
    return torch.stack(preds), y[folds.te_idx]


def analytical_cv(x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float = 0.0,
                  mode: str = "auto"):
    """Analytical ridge-regression CV (Eq. 14): exact fold predictions from a
    single full-data hat matrix. Returns (preds_te, y_te), both (K, m).

    The plan has no train blocks, so on CUDA the predictions come from the
    fused ``fold_eval`` kernel."""
    plan = fastcv.prepare(x, folds, lam, mode=mode, with_train_block=False)
    preds, _ = fastcv.cv_errors(plan, y.to(x.dtype))
    return preds, y[folds.te_idx]
