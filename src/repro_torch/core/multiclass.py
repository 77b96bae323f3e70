"""Multi-class LDA: direct form, optimal scoring, and analytical CV.

Implements the paper's extension to multi-class LDA (§2.8-2.10, Algorithm 2):

Step 1  Multivariate ridge regression of the class-indicator matrix Y on X̃,
        cross-validated *exactly* via the hat-matrix identities (Eq. 14/15),
        column-wise over classes — shares :mod:`repro_torch.core.fastcv`.
Step 2  Optimal scores from the C×C eigenproblem of M = Ẏ_Trᵀ Y_Tr / N_Tr,
        solved as the *generalised* problem M θ = α² D_π θ with
        D_π = Y_Trᵀ Y_Tr / N_Tr (Hastie et al. 1995): whitening by D_π^{-1/2}
        makes it a symmetric ``eigh``, and the trivial pair (α² = 1,
        θ = 1_C) is exact and unambiguous to drop.
Scaling W = B Θ D with D = N^{-1/2} diag(α²(1−α²))^{-1/2} (paper §2.9,
including the √N covariance-vs-scatter correction).

Classification is nearest-centroid in discriminant space; the intercept
column of X̃ shifts all scores and centroids equally, so distances (and
hence predictions) are unaffected (paper §2.10).

Step 2 runs batched: every (label vector, fold) pair is one C×C ``eigh``
of a single batched call. Step 1 of a batch of B label vectors is one
(N, B·C) column block through ``fastcv.cv_errors``; ``fused=None`` takes
the kernel route (``hat_apply`` + ``foldsolve``) on CUDA and the Cholesky
composite on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import fastcv
from repro_torch.core.folds import Folds

__all__ = [
    "onehot",
    "MulticlassLDA",
    "fit_multiclass",
    "predict_multiclass",
    "optimal_scoring_fit",
    "standard_cv_multiclass",
    "analytical_cv_multiclass",
    "batch_predict",
    "make_eval_multiclass",
]

_EPS = 1e-10


def onehot(y: torch.Tensor, num_classes: int, dtype=torch.float64) -> torch.Tensor:
    """(..., C) indicator rows; a label outside [0, C) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=y.device)
    return (y[..., None] == classes).to(dtype)


# ---------------------------------------------------------------------------
# Direct multi-class LDA (the paper's standard-approach comparator, §2.8)
# ---------------------------------------------------------------------------


class MulticlassLDA(NamedTuple):
    w: torch.Tensor          # (P, C-1) discriminant coordinates, Wᵀ(S_w+λI)W = I
    centroids: torch.Tensor  # (C, C-1) projected class means


def _scatter_matrices(x: torch.Tensor, y1h: torch.Tensor):
    """S_w, S_b and class means from one-hot labels (Eq. in §2.8)."""
    counts = y1h.sum(dim=0)                                  # (C,)
    n = x.shape[0]
    m = (y1h.T @ x) / torch.clamp(counts, min=1.0)[:, None]  # (C, P) class means
    mbar = (counts[:, None] * m).sum(dim=0) / n              # (P,) sample mean
    st = x.T @ x                                             # total raw scatter
    sw = st - (m * counts[:, None]).T @ m                    # within-class
    mc = m - mbar[None, :]
    sb = (mc * counts[:, None]).T @ mc                       # between-classes
    return sw, sb, m, counts


def fit_multiclass(x: torch.Tensor, y1h: torch.Tensor, lam: float = 0.0) -> MulticlassLDA:
    """Generalised eigenproblem S_b W = (S_w + λI) W Λ via Cholesky whitening."""
    c = y1h.shape[1]
    p = x.shape[1]
    sw, sb, m, _ = _scatter_matrices(x, y1h)
    l = torch.linalg.cholesky(sw + lam * torch.eye(p, dtype=x.dtype, device=x.device))
    a = torch.linalg.solve_triangular(l, sb, upper=False)
    a = torch.linalg.solve_triangular(l, a.T, upper=False)      # L⁻¹ S_b L⁻ᵀ
    a = 0.5 * (a + a.T)
    _, vecs = torch.linalg.eigh(a)                               # ascending
    top = vecs.flip(-1)[:, : c - 1]                              # top C-1, descending
    w = torch.linalg.solve_triangular(l.T, top, upper=True)      # W = L⁻ᵀ U
    return MulticlassLDA(w, m @ w)


def predict_multiclass(x: torch.Tensor, model: MulticlassLDA) -> torch.Tensor:
    """Nearest-centroid classification in discriminant space."""
    scores = x @ model.w                                         # (N, C-1)
    d2 = ((scores[:, None, :] - model.centroids[None]) ** 2).sum(dim=-1)
    return d2.argmin(dim=-1)


# ---------------------------------------------------------------------------
# Optimal scoring (full-data fit; Hastie et al. 1995, paper §2.9)
# ---------------------------------------------------------------------------


def _os_step2(m: torch.Tensor, d_pi: torch.Tensor, n_tr: int):
    """Solve M θ = α² D_π θ; drop the trivial pair; return (Θ·D, α²).

    Batched over leading dimensions: m (..., C, C) is Ẏ_Trᵀ Y_Tr / N_Tr
    (symmetric up to float noise), d_pi (..., C) the class proportions of
    the training fold. Returns Θ·D (..., C, C-1) and α² (..., C-1),
    descending. α² is clipped to [ε, 1 − ε] with the reference's ε = 1e-10,
    which rounds to 1 in float32: an α² of 1 there makes D infinite.
    """
    c = m.shape[-1]
    dm = 1.0 / torch.sqrt(torch.clamp(d_pi, min=_EPS))
    ms = dm[..., :, None] * m * dm[..., None, :]
    ms = 0.5 * (ms + ms.transpose(-1, -2))
    evals, evecs = torch.linalg.eigh(ms)                     # ascending; trivial α²=1 last
    keep = torch.arange(c - 2, -1, -1, device=m.device)      # descending, drop last
    a2 = torch.clamp(evals[..., keep], _EPS, 1.0 - _EPS)
    theta = dm[..., :, None] * evecs[..., keep]              # θᵀD_πθ = I
    d = 1.0 / (torch.sqrt(torch.tensor(float(n_tr), dtype=m.dtype, device=m.device))
               * torch.sqrt(a2 * (1.0 - a2)))
    return theta * d[..., None, :], a2


def optimal_scoring_fit(x: torch.Tensor, y1h: torch.Tensor, lam: float = 0.0):
    """Full-data optimal scoring. Returns (w_os (P, C-1), α² (C-1,)); w_os
    equals the direct-LDA W up to per-column sign."""
    n, p = x.shape
    xa = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
    i0 = torch.eye(p + 1, dtype=x.dtype, device=x.device)
    i0[p, p] = 0.0
    a = xa.T @ xa + lam * i0
    b = torch.cholesky_solve(xa.T @ y1h, torch.linalg.cholesky(a))   # (P+1, C)
    y_fit = xa @ b                                                   # Ŷ = HY
    m = y_fit.T @ y1h / n
    d_pi = y1h.sum(dim=0) / n
    theta_d, a2 = _os_step2(m, d_pi, n)
    return b[:-1] @ theta_d, a2                                      # B Θ D, bias row dropped


# ---------------------------------------------------------------------------
# Standard approach: retrain direct LDA on every fold (O(KNP² + KP³))
# ---------------------------------------------------------------------------


def standard_cv_multiclass(x: torch.Tensor, y: torch.Tensor, folds: Folds,
                           num_classes: int, lam: float = 0.0):
    """Retrain-per-fold direct multi-class LDA. Returns (pred (K, m), y_te).

    Folds run one after another, so a timing reflects the standard
    approach's true cost.
    """
    y1h = onehot(y, num_classes, dtype=x.dtype)
    preds = [predict_multiclass(x[te], fit_multiclass(x[tr], y1h[tr], lam))
             for te, tr in zip(folds.te_idx, folds.tr_idx)]
    return torch.stack(preds), y[folds.te_idx]


# ---------------------------------------------------------------------------
# Analytical approach (Algorithm 2)
# ---------------------------------------------------------------------------


def _fold_distances(y_dot_te: torch.Tensor, y_dot_tr: torch.Tensor,
                    y1h_tr: torch.Tensor):
    """Step 2 + squared centroid distances, batched over leading dimensions.

    y_dot_te: (..., m, C) CV regression fits on the test fold
    y_dot_tr: (..., N-m, C) CV regression fits on the training fold
    y1h_tr:   (..., N-m, C) one-hot training labels
    Returns d2 (..., m, C), whose argmin is the prediction, and α² (..., C-1).
    """
    n_tr = y1h_tr.shape[-2]
    counts = y1h_tr.sum(dim=-2)                                  # (..., C)
    m_mat = y_dot_tr.transpose(-1, -2) @ y1h_tr / n_tr           # Ẏ_Trᵀ Y_Tr / N_Tr
    theta_d, a2 = _os_step2(m_mat, counts / n_tr, n_tr)
    scores_te = y_dot_te @ theta_d                               # (..., m, C-1)
    scores_tr = y_dot_tr @ theta_d                               # (..., N-m, C-1)
    centroids = (y1h_tr.transpose(-1, -2) @ scores_tr) / torch.clamp(counts, min=1.0)[..., None]
    d2 = ((scores_te[..., :, None, :] - centroids[..., None, :, :]) ** 2).sum(dim=-1)
    return d2, a2


def _batch_distances(plan: fastcv.CVPlan, y_batch: torch.Tensor, num_classes: int,
                     fused: Optional[bool] = None):
    """Algorithm 2 up to the centroid distances for a (B, N) label batch.

    Step 1 is one (N, B·C) column block through ``fastcv.cv_errors`` — one
    ``hat_apply`` and one ``foldsolve`` launch (its residual check and
    retry inside) on the kernel route — and step 2 one batched C×C
    ``eigh`` over (B, K).
    Returns d2 (B, K, m, C) and α² (B, K, C-1).
    """
    dtype = plan.h.dtype
    bsz, n = y_batch.shape
    y1h = onehot(y_batch, num_classes, dtype=dtype)                  # (B, N, C)
    cols = y1h.permute(1, 0, 2).reshape(n, bsz * num_classes).contiguous()
    y_dot_te, y_dot_tr = fastcv.cv_errors(plan, cols, fused=fused)  # (K, m, B·C)
    k, m = y_dot_te.shape[:2]
    y_dot_te = y_dot_te.reshape(k, m, bsz, num_classes).permute(2, 0, 1, 3)
    y_dot_tr = y_dot_tr.reshape(k, -1, bsz, num_classes).permute(2, 0, 1, 3)
    y1h_tr = y1h[:, plan.tr_idx]                                     # (B, K, N-m, C)
    return _fold_distances(y_dot_te, y_dot_tr, y1h_tr)


def batch_predict(plan: fastcv.CVPlan, y_batch: torch.Tensor, num_classes: int, *,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """Algorithm 2 for a batch of label vectors sharing one plan.

    ``y_batch``: int (B, N) — e.g. permutations or many client requests.
    Returns int predictions (B, K, m). All B·C indicator columns share one
    step-1 evaluation (the reference's ``fused=True`` column flattening, on
    either route); ``fused`` as in ``fastcv.cv_errors``.
    """
    d2, _ = _batch_distances(plan, y_batch, num_classes, fused=fused)
    return d2.argmin(dim=-1)


def analytical_cv_multiclass(x: torch.Tensor, y: torch.Tensor, folds: Folds,
                             num_classes: int, lam: float = 0.0,
                             mode: str = "auto",
                             plan: Optional[fastcv.CVPlan] = None, *,
                             fused: Optional[bool] = None):
    """Algorithm 2: exact CV for multi-class LDA from one full-data fit.

    Returns (pred (K, m), y_te (K, m)).
    """
    if plan is None:
        plan = fastcv.prepare(x, folds, lam, mode=mode, with_train_block=True)
    preds = batch_predict(plan, y[None, :], num_classes, fused=fused)[0]
    return preds, y[plan.te_idx]


def make_eval_multiclass(num_classes: int, fused: Optional[bool] = None):
    """Evaluator ``(plan, y (B, N) int) -> preds (B, K, m)``; ``fused`` as
    in ``fastcv.cv_errors``."""
    return lambda plan, y: batch_predict(plan, y, num_classes, fused=fused)
