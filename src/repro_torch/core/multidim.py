"""Multi-dimensional analyses (paper §4.2): CV grids, fold weights (Eq. 12),
time-generalization.

* :func:`cv_grid` — a classifier validated at every point of a feature
  grid (time points, frequencies, searchlights): analytical CV point by
  point, each through ``fastcv.binary_cv`` (so on a CUDA tensor each point
  runs the ``hat_apply`` and ``foldsolve`` kernels).

* :func:`fold_weights` — the paper derives the updated weights β̇ (Eq. 12)
  but never materialises them ("does not need to be calculated
  explicitly"). For *time-generalization* — train at time t₁, test at
  t₂ ≠ t₁ — the test features differ from the training features, so the
  decision values ẏ_Te = X̃[t₂] β̇[t₁] genuinely need β̇. They come from the
  dual ridge on each fold's training rows, all K folds as one batch —
  O(K·N³ + K·N²P), never P×P.

* :func:`time_generalization` — the full (t_train × t_test) accuracy
  matrix, diagonal = ordinary CV up to the bias convention.
"""

from __future__ import annotations

import torch

from repro_torch.core import fastcv, metrics
from repro_torch.core.folds import Folds
from repro_torch.core.spans import span

__all__ = ["cv_grid", "fold_weights", "time_generalization"]


def cv_grid(xs: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float,
            adjust_bias: bool = True) -> torch.Tensor:
    """Analytical binary CV at every grid point.

    xs: (Q, N, P) — Q independent feature sets sharing labels and folds.
    Returns accuracies (Q,), float32 as ``metrics.binary_accuracy`` gives
    them.
    """
    y = y.to(xs.dtype)
    accs = []
    for x in xs:
        with span("grid_point"):
            accs.append(metrics.binary_accuracy(*fastcv.binary_cv(
                x, y, folds, lam=lam, adjust_bias=adjust_bias)))
    return torch.stack(accs)


def fold_weights(x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float):
    """Exact per-fold ridge weights (w_k (K, P), b_k (K,)) in dual form.

    Never forms a P×P matrix: the (N_tr × N_tr) dual on the training rows
    of all K folds is one batched solve — the Eq.-12 path made explicit for
    cross-feature-set evaluation.
    """
    y = y.to(x.dtype)
    tr = folds.tr_idx.long()
    x_tr, y_tr = x[tr], y[tr]                             # (K, N_tr, P), (K, N_tr)
    mu = x_tr.mean(dim=1, keepdim=True)                   # (K, 1, P)
    xc = x_tr - mu
    yc = y_tr - y_tr.mean(dim=1, keepdim=True)
    eye = torch.eye(tr.shape[1], dtype=x.dtype, device=x.device)
    g = torch.bmm(xc, xc.transpose(1, 2)) + lam * eye
    # G + λI is positive definite (λ > 0): a batched Cholesky, half the
    # work of a general solve
    alpha = torch.cholesky_solve(yc[:, :, None], torch.linalg.cholesky(g))   # (K, N_tr, 1)
    w = torch.bmm(xc.transpose(1, 2), alpha)[:, :, 0]     # (K, P)
    b = y_tr.mean(dim=1) - (mu[:, 0, :] * w).sum(dim=1)
    return w, b


def time_generalization(xs: torch.Tensor, y: torch.Tensor, folds: Folds,
                        lam: float) -> torch.Tensor:
    """(T_train, T_test) CV-accuracy matrix (King & Dehaene-style).

    xs: (T, N, P). Each fold's model trained on xs[t1][train rows] is
    evaluated on xs[t2][test rows] for every t2; the diagonal reproduces
    :func:`cv_grid` up to the bias convention. Float32 accuracies, as
    ``metrics.share`` rounds them.

    The test rows of every time point are gathered once, as (K, m, T, P):
    each fold's rows are then one operand of a batched product with that
    fold's weights, for all T test points at once. At T = 301, K = 10,
    m = 78, P = 380 in f32 that gather holds 357 MB.
    """
    t_pts = xs.shape[0]
    y = y.to(xs.dtype)
    te = folds.te_idx.long()
    k, m = te.shape
    hits_want = torch.sign(y[te])[:, :, None]             # (K, m, 1)
    x_te = xs.transpose(0, 1)[te].reshape(k, m * t_pts, -1)   # (K, m·T, P)
    out = []
    for t1 in range(t_pts):
        ws, bs = fold_weights(xs[t1], y, folds, lam)      # (K, P), (K,)
        dv = torch.bmm(x_te, ws[:, :, None]).reshape(k, m, t_pts) + bs[:, None, None]
        hits = (torch.where(dv >= 0, 1.0, -1.0).to(dv.dtype) == hits_want)
        out.append(metrics.share(hits.sum(dim=(0, 1)), k * m))
    return torch.stack(out)
