"""The numbers that decide ``correct``, each a distance from the reference.

Every function takes the program's answers and the reference's, both on
one device, and returns a float that is 0 for a perfect match.
"""

from __future__ import annotations

import math
import statistics

import torch


def dval_error(dvals: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a decision value from the reference's, as a share of
    the root mean square of the reference's decision values."""
    ref = ref.to(torch.float64)
    gap = (dvals.to(torch.float64) - ref).abs().max()
    return float(gap / ref.pow(2).mean().sqrt())


def class_gap(pred: torch.Tensor, d2_ref: torch.Tensor) -> float:
    """Widest gap by which the class the program predicts lies farther from
    the trial's scores than the reference's nearest centroid, as a share of
    the median spread (farthest minus nearest centroid) over the trials.

    pred: (K, m) classes; d2_ref: (K, m, C) squared centroid distances."""
    d2_ref = d2_ref.to(torch.float64)
    chosen = torch.gather(d2_ref, 2, pred.long()[..., None])[..., 0]
    best = d2_ref.min(dim=2).values
    spread = (d2_ref.max(dim=2).values - best).median()
    return float((chosen - best).max() / spread)


def hit_gap(hits: torch.Tensor, dvals_ref: torch.Tensor, y_te: torch.Tensor) -> float:
    """How wrong the program must have been to count the hits it counts.

    For each label vector b the program reports only its count of correct
    test trials, ``hits[b]``. Where that differs from the reference's by
    d, at least |d| trials were classified otherwise than the reference
    classifies them, and the least it takes is the |d| trials nearest the
    reference's decision boundary. The gap of a vector is the |d|-th
    smallest |decision value| of the reference among the trials that could
    have turned (those it classifies correctly when the program counts
    fewer hits, the others when more), as a share of the root mean square
    of the vector's decision values; the number is the widest gap over the
    vectors (infinite when no |d| trials can explain the count).

    hits: (B,); dvals_ref, y_te: (K, m, B).
    """
    b = dvals_ref.shape[-1]
    ref = dvals_ref.reshape(-1, b).to(torch.float64)
    right = torch.where(ref >= 0, 1.0, -1.0) == torch.sign(y_te.reshape(-1, b)).to(ref.dtype)
    d = hits.to(torch.float64) - right.sum(dim=0)
    size = ref.abs() / ref.pow(2).mean(dim=0).sqrt()
    inf = torch.full_like(size, float("inf"))
    could_turn = torch.where(d < 0, right, ~right)
    ranked = torch.where(could_turn, size, inf).sort(dim=0).values
    k = d.abs().long()
    pad = torch.cat([torch.zeros_like(ranked[:1]), ranked, inf[:1]])
    gap = pad.gather(0, k.clamp(max=ranked.shape[0] + 1)[None])[0]
    return float(gap.max())


def hits_of(accuracy: torch.Tensor, tested: int) -> torch.Tensor:
    """Correct test trials behind accuracies that the program gives as
    float32 shares of ``tested`` trials."""
    return torch.round(accuracy.to(torch.float64) * tested)


def ks_distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """Two-sample Kolmogorov-Smirnov distance of two samples (of hit
    counts), scaled by sqrt(n m / (n + m)) so that its reading under the
    same distribution does not grow with the samples' sizes."""
    a, b = a.to(torch.float64).flatten().sort().values, b.to(torch.float64).flatten().sort().values
    n, m = a.numel(), b.numel()
    grid = torch.cat([a, b]).unique()
    fa = torch.searchsorted(a, grid, right=True).to(torch.float64) / n
    fb = torch.searchsorted(b, grid, right=True).to(torch.float64) / m
    return float((fa - fb).abs().max()) * math.sqrt(n * m / (n + m))


def position_chi2(perms: torch.Tensor) -> float:
    """How far value-by-position counts of permutation rows (R, N) lie from
    a uniform draw's: Pearson's chi-square of the N x N table of how often
    row entry j holds value v, as |z| against its mean N (N - 1) under
    uniform rows (each count is binomial, R and 1/N), in units of
    sqrt(2) (N - 1). Too even a table (rotated rows) reads as far as too
    uneven a one."""
    r, n = perms.shape
    cells = (perms.to(torch.int64) * n + torch.arange(n, device=perms.device)).reshape(-1)
    counts = torch.bincount(cells, minlength=n * n).to(torch.float64)
    e = r / n
    stat = float(((counts - e) ** 2).sum()) / e
    return abs(stat - n * (n - 1)) / (math.sqrt(2.0) * (n - 1))


def p95(values) -> float:
    """95th percentile (inclusive quantiles over all values)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])
