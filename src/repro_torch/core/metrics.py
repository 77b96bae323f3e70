"""Classification / regression performance metrics.

All metrics consume *decision values* (the paper's ``dvals``) or
discriminant scores. :func:`auc_rows` evaluates the rank-sum AUC of many
rows at once, which is how the permutation test scores every (fold,
permutation) pair of a chunk in one pass.
"""

from __future__ import annotations

import torch

__all__ = [
    "binary_accuracy",
    "share",
    "auc",
    "auc_rows",
    "multiclass_accuracy",
    "confusion_matrix",
    "mse",
    "r2",
]


def binary_accuracy(dvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Accuracy of sign(dval) against labels coded ±1 (paper §2.2), as a
    float32 share of hits, as the reference returns it."""
    pred = torch.where(dvals >= 0, 1.0, -1.0).to(dvals.dtype)
    hits = (pred == torch.sign(y).to(pred.dtype)).to(torch.float32)
    return share(hits.sum(), hits.numel())


def share(count: torch.Tensor, n: int) -> torch.Tensor:
    """count / n in float32, rounded as the reference's mean rounds it: the
    count times the float32 reciprocal of n (XLA's division by a constant)."""
    return count.to(torch.float32) * torch.tensor(1.0 / n, dtype=torch.float32,
                                                  device=count.device)


def auc_rows(dvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Rank-sum (Mann-Whitney U) AUC of each row; dvals, y: (R, n) → (R,).

    Ties in ``dvals`` get mid-ranks. Labels are ±1.
    """
    n = dvals.shape[-1]
    sorted_d, order = torch.sort(dvals, dim=-1, stable=True)
    first = torch.searchsorted(sorted_d, sorted_d, side="left")
    last = torch.searchsorted(sorted_d, sorted_d, side="right")
    mid = (first + 1 + last).to(dvals.dtype) / 2.0
    ranks = torch.empty_like(mid).scatter_(-1, order, mid)
    pos = y > 0
    n_pos = pos.sum(dim=-1).to(dvals.dtype)
    n_neg = n - n_pos
    rank_sum_pos = torch.where(pos, ranks, torch.zeros((), dtype=dvals.dtype,
                                                       device=dvals.device)).sum(dim=-1)
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    denom = torch.clamp(n_pos * n_neg, min=1.0)
    return u / denom


def auc(dvals: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Area under the ROC curve of all values; bias-term independent (§2.5)."""
    return auc_rows(dvals.reshape(1, -1), y.reshape(1, -1))[0]


def multiclass_accuracy(pred_labels: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Share of exact label hits, as a float32 :func:`share` (the reference's
    mean rounds as count × f32(1/n), not as a true division)."""
    hits = pred_labels == y
    return share(hits.sum(), hits.numel())


def confusion_matrix(pred_labels: torch.Tensor, y: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(C, C) matrix: rows = true class, cols = predicted class."""
    idx = (y * num_classes + pred_labels).reshape(-1).long()
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def mse(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((y_pred - y) ** 2).mean()


def r2(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    ss_res = ((y - y_pred) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - ss_res / torch.clamp(ss_tot, min=torch.finfo(y.dtype).tiny)
