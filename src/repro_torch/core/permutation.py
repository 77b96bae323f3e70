"""Permutation testing with the analytical approach (paper §2.7, Alg. 1 & 2).

The hat matrix H depends on features only, so it is computed ONCE; each
permutation σ only needs ê = yσ − H yσ and the per-fold solves. Permutations
are evaluated in chunks of ``chunk`` label vectors, so T can be large
without exhausting memory. On CUDA a binary chunk is one ``hat_apply`` and
one ``foldsolve`` launch (bias adjust) or one ``fold_eval`` launch
(without), each fold-solve launch with its residual check and jitter retry
inside; a multi-class chunk flattens its permutations' indicator columns
into one (N, chunk·C) block, so it too is one ``hat_apply`` and one
``foldsolve``, followed by one batched C×C ``eigh`` over (chunk, K).

The standard-approach baselines (retrain K models per permutation) are
kept for the paper's comparison (Fig. 3 right panels, Fig. 4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import fastcv, lda, metrics, multiclass
from repro_torch.core.folds import Folds
from repro_torch.core.spans import span
from repro_torch.kernels.common import resolve_device

__all__ = [
    "PermutationResult",
    "permutation_indices",
    "analytical_permutation_binary",
    "standard_permutation_binary",
    "analytical_permutation_multiclass",
    "standard_permutation_multiclass",
    "p_value",
]


class PermutationResult(NamedTuple):
    observed: torch.Tensor    # () metric on unpermuted labels
    null: torch.Tensor        # (T,) null distribution
    p: torch.Tensor           # () permutation p-value


def p_value(observed: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """(1 + #{null >= obs}) / (1 + T) — standard permutation p-value."""
    t = null.shape[0]
    return (1.0 + (null >= observed).sum().to(torch.float64)) / (1.0 + t)


def permutation_indices(seed: int, n: int, n_perm: int, *, device=None) -> torch.Tensor:
    """(T, N) int64 independent label permutations.

    *Prefix-stable*: row t is drawn by its own ``torch.Generator`` seeded
    from (seed, t) through numpy's ``SeedSequence``, so it depends only on
    (seed, t) — a larger T yields the same leading rows. The rows differ
    between devices (CPU and CUDA generators differ), never between runs.
    ``device=None`` means ``cuda``.
    """
    dev = resolve_device(device)
    with span("draw"):
        rows = []
        for t in range(n_perm):
            state = np.random.SeedSequence([seed, t]).generate_state(1, np.uint64)[0]
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)
            rows.append(torch.randperm(n, generator=gen, device=dev))
        return torch.stack(rows) if rows else torch.empty((0, n), dtype=torch.int64,
                                                          device=dev)


def _fold_metric_binary(dvals: torch.Tensor, y_te: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-fold metric averaged over folds. dvals/y_te: (K, m[, B]).
    Accuracy is a float32 share of hits, as in the reference."""
    if metric == "accuracy":
        pred = torch.where(dvals >= 0, 1.0, -1.0).to(dvals.dtype)
        hits = (pred == torch.sign(y_te).to(dvals.dtype)).to(torch.float32)
        return metrics.share(hits.sum(dim=(0, 1)), hits.shape[0] * hits.shape[1])
    if metric == "auc":
        if dvals.ndim == 2:
            return metrics.auc_rows(dvals, y_te).mean()
        k, m, b = dvals.shape
        rows = lambda a: a.permute(0, 2, 1).reshape(k * b, m)
        return metrics.auc_rows(rows(dvals), rows(y_te)).reshape(k, b).mean(dim=0)
    raise ValueError(f"unknown metric {metric!r}")


def analytical_permutation_binary(
    x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float, n_perm: int,
    seed: int, metric: str = "accuracy", mode: str = "auto",
    chunk: int = 256, adjust_bias: bool = True,
) -> PermutationResult:
    """Algorithm 1: H once, then T permutations of cheap fold solves."""
    plan = fastcv.prepare(x, folds, lam, mode=mode, with_train_block=adjust_bias)
    y = y.to(plan.h.dtype)
    dv_obs = fastcv.binary_dvals(plan, y, adjust_bias=adjust_bias)
    observed = _fold_metric_binary(dv_obs, y[plan.te_idx], metric)

    perms = permutation_indices(seed, y.shape[0], n_perm, device=y.device)
    null = []
    for c0 in range(0, n_perm, chunk):
        yp = y[perms[c0:c0 + chunk]].T.contiguous()           # (N, chunk)
        dv = fastcv.binary_dvals(plan, yp, adjust_bias=adjust_bias)
        null.append(_fold_metric_binary(dv, yp[plan.te_idx], metric))
    null = torch.cat(null) if null else torch.empty(0, dtype=y.dtype, device=y.device)
    return PermutationResult(observed, null, p_value(observed, null))


def standard_permutation_binary(
    x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float, n_perm: int,
    seed: int, metric: str = "accuracy",
) -> PermutationResult:
    """Paper's standard approach: retrain K classifiers per permutation."""
    y = y.to(x.dtype)
    dv_obs, y_te = lda.standard_cv_binary(x, y, folds, lam=lam)
    observed = _fold_metric_binary(dv_obs, y_te, metric)
    perms = permutation_indices(seed, y.shape[0], n_perm, device=y.device)
    null = []
    for perm in perms:
        dv, yte = lda.standard_cv_binary(x, y[perm], folds, lam=lam)
        null.append(_fold_metric_binary(dv, yte, metric))
    null = torch.stack(null) if null else torch.empty(0, dtype=y.dtype, device=y.device)
    return PermutationResult(observed, null, p_value(observed, null))


def analytical_permutation_multiclass(
    x: torch.Tensor, y: torch.Tensor, folds: Folds, num_classes: int, lam: float,
    n_perm: int, seed: int, mode: str = "auto", chunk: int = 64,
) -> PermutationResult:
    """Algorithm 2 under permutations: step 1 of each chunk is one column
    block through the shared plan; step 2 (C×C eigh) is batched over
    (permutations × folds)."""
    plan = fastcv.prepare(x, folds, lam, mode=mode, with_train_block=True)
    pred_obs, y_te_obs = multiclass.analytical_cv_multiclass(
        x, y, folds, num_classes, lam, mode=mode, plan=plan)
    observed = metrics.multiclass_accuracy(pred_obs, y_te_obs)

    perms = permutation_indices(seed, y.shape[0], n_perm, device=y.device)
    k, m = plan.te_idx.shape
    null = []
    for c0 in range(0, n_perm, chunk):
        yp = y[perms[c0:c0 + chunk]]                           # (chunk, N)
        preds = multiclass.batch_predict(plan, yp, num_classes)  # (chunk, K, m)
        hits = preds == yp[:, plan.te_idx]
        null.append(metrics.share(hits.sum(dim=(1, 2)), k * m))
    null = torch.cat(null) if null else torch.empty(0, dtype=torch.float32, device=y.device)
    return PermutationResult(observed, null, p_value(observed, null))


def standard_permutation_multiclass(
    x: torch.Tensor, y: torch.Tensor, folds: Folds, num_classes: int, lam: float,
    n_perm: int, seed: int,
) -> PermutationResult:
    """Standard approach: retrain direct multi-class LDA K times per σ."""
    pred_obs, y_te_obs = multiclass.standard_cv_multiclass(x, y, folds, num_classes, lam)
    observed = metrics.multiclass_accuracy(pred_obs, y_te_obs)
    perms = permutation_indices(seed, y.shape[0], n_perm, device=y.device)
    null = [metrics.multiclass_accuracy(*multiclass.standard_cv_multiclass(
        x, y[perm], folds, num_classes, lam)) for perm in perms]
    null = torch.stack(null) if null else torch.empty(0, dtype=torch.float32, device=y.device)
    return PermutationResult(observed, null, p_value(observed, null))
