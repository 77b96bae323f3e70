"""Fold generation for k-fold / leave-one-out cross-validation.

Folds are *dense index tensors* with static shapes so that all folds are
evaluated as one batched computation:

  te_idx : (K, m)      indices of the test samples of each fold, m = N // K
  tr_idx : (K, N - m)  indices of the training samples of each fold

If ``N % K != 0`` the trailing ``N % K`` samples (after shuffling) are on the
*training* side of every fold: every sample is used for training but only
``K * (N // K)`` samples are ever tested (the paper's equally sized folds,
§2.1). Indices are int32 and drawn with numpy's ``default_rng``, so they
equal the reference package's for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["Folds", "kfold", "loo", "stratified_kfold", "repeated_kfold"]


@dataclasses.dataclass(frozen=True)
class Folds:
    """Static-shape fold index sets.

    Attributes:
      te_idx: int32 (K, m) test-sample indices per fold.
      tr_idx: int32 (K, N - m) training-sample indices per fold.
      n: total number of samples N.
    """

    te_idx: torch.Tensor
    tr_idx: torch.Tensor
    n: int

    @property
    def k(self) -> int:
        return self.te_idx.shape[0]

    @property
    def test_size(self) -> int:
        return self.te_idx.shape[1]

    @property
    def train_size(self) -> int:
        return self.tr_idx.shape[1]

    @classmethod
    def with_indices(cls, te_idx, tr_idx, n: Optional[int] = None) -> "Folds":
        """Folds from raw index tensors. ``n`` defaults to ``test_size +
        train_size``, which equals N whenever K divides N."""
        if n is None:
            n = int(te_idx.shape[1] + tr_idx.shape[1])
        return cls(te_idx, tr_idx, n)


def _complement(te_idx: np.ndarray, n: int) -> np.ndarray:
    """Training indices = complement of each fold's test indices (+ leftovers)."""
    k = te_idx.shape[0]
    tr = np.empty((k, n - te_idx.shape[1]), dtype=np.int32)
    full = np.arange(n, dtype=np.int32)
    for i in range(k):
        mask = np.ones(n, dtype=bool)
        mask[te_idx[i]] = False
        tr[i] = full[mask]
    return tr


def _folds(te: np.ndarray, n: int, device) -> Folds:
    dev = resolve_device(device)
    tr = _complement(te, n)
    return Folds(torch.from_numpy(te).to(dev), torch.from_numpy(tr).to(dev), n)


def kfold(n: int, k: int, seed: int = 0, shuffle: bool = True, *,
          device=None) -> Folds:
    """Plain k-fold partition with equal fold sizes m = n // k."""
    if not 2 <= k <= n:
        raise ValueError(f"need 2 <= k <= n, got k={k}, n={n}")
    m = n // k
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n) if shuffle else np.arange(n)
    te = perm[: k * m].reshape(k, m).astype(np.int32)
    return _folds(te, n, device)


def loo(n: int, *, device=None) -> Folds:
    """Leave-one-out: K = N folds of size 1."""
    return _folds(np.arange(n, dtype=np.int32).reshape(n, 1), n, device)


def stratified_kfold(labels, k: int, seed: int = 0, *, device=None) -> Folds:
    """Stratified k-fold: class proportions approximately preserved per fold.

    Samples of each class are shuffled and dealt round-robin across folds;
    the concatenated per-fold lists are trimmed to the minimum fold size so
    shapes stay static.
    """
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    y = np.asarray(labels)
    n = y.shape[0]
    rng = np.random.default_rng(seed)
    buckets: list[list[int]] = [[] for _ in range(k)]
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        for j, sample in enumerate(idx):
            buckets[j % k].append(int(sample))
    m = min(len(b) for b in buckets)
    te = np.stack([rng.permutation(np.asarray(b, dtype=np.int32))[:m] for b in buckets])
    return _folds(te, n, device)


def repeated_kfold(n: int, k: int, repeats: int, seed: int = 0, *,
                   device=None) -> list[Folds]:
    """Repeated k-fold (paper §2.1: average across repeats)."""
    return [kfold(n, k, seed=seed + r, device=device) for r in range(repeats)]
