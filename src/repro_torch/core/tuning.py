"""Hyperparameter tuning with the analytical machinery (beyond the paper).

The hat matrix makes LOO cross-validation *algebraically free* per ridge
λ once the centered Gram is eigendecomposed:

    G_c = U diag(g) Uᵀ            (one O(N³) eigh)
    H(λ) = 1/N·11ᵀ + U diag(g/(g+λ)) Uᵀ       (O(N²) per λ)
    LOO:  ė_i = ê_i / (1 − H_ii(λ))            (Eq. 14 with m = 1)

so a whole λ grid costs little more than a single fit — the natural
companion to the paper's §2.6 recommendation to use ridge, removing the
one hyperparameter the analytical approach asks for. (The paper tunes
nothing; shrinkage practice uses Ledoit-Wolf — also available via
repro_torch.core.shrinkage and convertible with Eq. 18.)

The O(N²P) Gram runs in X's dtype (the ``gram`` kernel on a CUDA tensor);
the N×N spectral work after it runs in float64 whatever that dtype. At the
small end of the default grid (λ = 1e-4·tr(G_c)/N) 1 − H_ii is about 1e-4,
a difference of numbers near 1: an f32 eigendecomposition leaves the
constant direction's eigenvalue at f32 rounding instead of 0 and the
eigenvectors orthonormal to f32 rounding only, and both errors land on
1 − H_ii unreduced. So G_c is also projected onto the complement of 1 (the
centering projector applied on both sides) before the eigendecomposition.
Scores are returned in the working dtype, as the reference returns them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.gram.ops import centered_gram

__all__ = ["RidgeTuneResult", "loo_curve", "tune_ridge"]


class RidgeTuneResult(NamedTuple):
    best_lambda: torch.Tensor   # ()
    best_score: torch.Tensor    # ()
    lambdas: torch.Tensor       # (L,)
    scores: torch.Tensor        # (L,) criterion per λ (lower is better)


def _eig_gram(x: torch.Tensor):
    """(g, U) of the centered Gram in float64, g clamped at 0."""
    g = centered_gram(x).to(torch.float64)
    g = g - g.mean(dim=0, keepdim=True)
    g = g - g.mean(dim=1, keepdim=True)
    evals, u = torch.linalg.eigh(g)
    return torch.clamp(evals, min=0.0), u


def loo_curve(x: torch.Tensor, y: torch.Tensor, lambdas, criterion: str = "mse"):
    """LOO CV curve over a λ grid from one eigendecomposition.

    y: (N,) continuous response or ±1 labels. criterion: "mse" (squared
    LOO residual) or "error" (misclassification of sign(ẏ)).
    Returns (L,) scores, exact per Eq. 14 (m=1).
    """
    n = x.shape[0]
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = y.to(dtype).to(torch.float64)
    evals, u = _eig_gram(x)
    # λ rounds to the working dtype, as the reference casts it
    lam = torch.as_tensor(lambdas, dtype=torch.float64, device=x.device).to(dtype).to(
        torch.float64)
    uy = u.T @ y                                        # (N,)
    w = evals[None, :] / (evals[None, :] + lam[:, None])   # (L, N) spectral filters
    # ŷ = H y = 1/N Σy + U diag(w) Uᵀ y, every λ at once
    y_hat = y.mean() + (w * uy) @ u.T                   # (L, N)
    # H_ii = 1/N + Σ_k w_k U_ik² (H = 1/N·11ᵀ + U W Uᵀ is additive): one
    # (N, N)·(N, L) product, no (L, N, N) temporary of w·U²
    h_diag = 1.0 / n + ((u * u) @ w.T).T                # (L, N)
    e_loo = (y - y_hat) / torch.clamp(1.0 - h_diag, min=1e-12)
    if criterion == "error":
        y_loo = y - e_loo
        scores = (torch.sign(y_loo) != torch.sign(y)).to(torch.float64).mean(dim=1)
    else:
        scores = (e_loo ** 2).mean(dim=1)
    return scores.to(dtype)


def tune_ridge(x: torch.Tensor, y: torch.Tensor, lambdas=None,
               criterion: str = "mse") -> RidgeTuneResult:
    """Pick λ by exact LOO over a (default log-spaced) grid.

    The default grid is tr(G_c)/N · logspace(-4, 2, 25); tr(G_c) is the
    centered design's squared norm, so the grid needs no Gram of its own.
    """
    if lambdas is None:
        xc = x - x.mean(dim=0, keepdim=True)
        scale = (xc * xc).sum() / x.shape[0]
        lambdas = scale * torch.logspace(-4, 2, 25, dtype=torch.float64, device=x.device)
    lambdas = torch.as_tensor(
        lambdas, dtype=None if isinstance(lambdas, torch.Tensor) else torch.float64,
        device=x.device)
    scores = loo_curve(x, y, lambdas, criterion=criterion)
    i = torch.argmin(scores)
    return RidgeTuneResult(lambdas[i], scores[i], lambdas, scores)
