"""Micro-batching: coalesce same-plan label queries into padded batches.

Analytical-CV evaluation is label-batched for free — ``fastcv.cv_errors``
broadcasts the cached fold solves over a trailing batch dimension — so the
cheapest way to serve many small requests (permutation chunks from many
clients, searchlight probes, RSA model RDMs) is to stack their label
vectors into one (N, B) batch, pad B up to a *shape bucket*, and run one
evaluation: on the card, one launch of each kernel of the eval route for
the whole group. Static bucket sizes bound the number of distinct launch
shapes an engine serves (``CVEngine.compile_count``).

Two layouts, matching the engine's eval paths:
  * columns  — binary / ridge: each query contributes (N,) or (N, b)
               response columns; batch is (N, B).
  * rows     — multi-class: each query contributes (N,) or (b, N) integer
               label rows; batch is (B, N).

The reference assembles batches in host NumPy because eager ``jnp`` ops
compile once per shape. Eager torch compiles nothing, so here the batch is
assembled on its queries' own device (``torch.cat`` and padding) and no
label tensor goes through the host. The result is a fresh, row-major
tensor — the layout the kernels take — and per-request outputs are views
of the one eval output. Segment and offset bookkeeping are the
reference's, and so are the results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.folds import Folds

# reprolint: monotonic-time
# (Any timing added to the coalescing path must use a monotonic clock.)

__all__ = ["DEFAULT_BUCKETS", "bucket_size", "as_folds", "MicroBatcher"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_size(b: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= b; beyond the largest, the next multiple of it."""
    if b <= 0:
        raise ValueError(f"batch size must be positive, got {b}")
    for s in buckets:
        if b <= s:
            return s
    top = buckets[-1]
    return -(-b // top) * top


def _index_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def as_folds(folds, device) -> Folds:
    """Normalise a folds spec onto ``device``: a Folds, or a raw
    (te_idx, tr_idx) pair.

    Requests may ship bare index arrays (e.g. sliced out of a grid of fold
    assignments); :meth:`Folds.with_indices` rebuilds the static-shape view.
    A Folds already on ``device`` is returned as is.
    """
    device = torch.device(device)
    if isinstance(folds, Folds):
        if folds.te_idx.device == device and folds.tr_idx.device == device:
            return folds
        return Folds(folds.te_idx.to(device), folds.tr_idx.to(device), folds.n)
    te_idx, tr_idx = folds
    return Folds.with_indices(_index_tensor(te_idx, device), _index_tensor(tr_idx, device))


@dataclasses.dataclass(frozen=True)
class _Segment:
    start: int  # first column/row of this query in the batch
    stop: int
    squeeze: bool  # query was a single vector, not a matrix


class MicroBatcher:
    """Coalesce ragged label queries; un-pad per-request on the way out.

    ``metrics``, when given, is a :class:`repro_torch.serve.obs.MetricsRegistry`
    with a ``batch_coalesced_size`` histogram: each coalesce observes the
    *unpadded* total width, so the distribution shows how full batches run
    relative to their shape buckets (padding waste = bucket − observed).

    Every coalesce assembles a *fresh* tensor (``torch.cat`` copies even a
    single query), so an eval never reads or writes a caller's tensor
    through the batch; the split methods read only the eval's output.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS, metrics=None):
        self.buckets = tuple(buckets)
        self.metrics = metrics

    def _observe(self, offset: int) -> None:
        if self.metrics is not None:
            self.metrics.observe("batch_coalesced_size", offset)

    # -- columns layout: binary / ridge ------------------------------------

    def coalesce_columns(self, ys: Sequence[torch.Tensor]):
        """Stack queries into (N, B_bucket); returns (batch, segments, B).

        Padding columns are zeros."""
        segments, cols, offset = [], [], 0
        for y in ys:
            squeeze = y.ndim == 1
            yc = y[:, None] if squeeze else y
            segments.append(_Segment(offset, offset + yc.shape[1], squeeze))
            cols.append(yc)
            offset += yc.shape[1]
        self._observe(offset)
        padded = bucket_size(offset, self.buckets)
        if padded > offset:
            first = cols[0]
            cols.append(first.new_zeros((first.shape[0], padded - offset)))
        return torch.cat(cols, dim=1), segments, offset

    def split_columns(self, out: torch.Tensor, segments: Sequence[_Segment]):
        """Invert :meth:`coalesce_columns` on an output with trailing B."""
        results = []
        for seg in segments:
            r = out[..., seg.start : seg.stop]
            results.append(r[..., 0] if seg.squeeze else r)
        return results

    def run_columns(self, ys: Sequence[torch.Tensor],
                    eval_fn: Callable[[torch.Tensor], torch.Tensor]):
        """One padded eval for all queries; per-query unpadded outputs."""
        batch, segments, _ = self.coalesce_columns(ys)
        return self.split_columns(eval_fn(batch), segments)

    # -- rows layout: multi-class ------------------------------------------

    def coalesce_rows(self, ys: Sequence[torch.Tensor]):
        """Stack queries into (B_bucket, N); returns (batch, segments, B).

        Padding rows repeat the first label row (all-zero "labels" would
        make the per-fold class-count matrix D_π singular in Algorithm 2's
        eigensolve; a real label vector is always well-posed)."""
        segments, rows, offset = [], [], 0
        for y in ys:
            squeeze = y.ndim == 1
            yr = y[None, :] if squeeze else y
            segments.append(_Segment(offset, offset + yr.shape[0], squeeze))
            rows.append(yr)
            offset += yr.shape[0]
        self._observe(offset)
        padded = bucket_size(offset, self.buckets)
        if padded > offset:
            first = rows[0][:1]
            rows.append(first.expand((padded - offset,) + tuple(first.shape[1:])))
        return torch.cat(rows, dim=0), segments, offset

    def split_rows(self, out: torch.Tensor, segments: Sequence[_Segment]):
        results = []
        for seg in segments:
            r = out[seg.start : seg.stop]
            results.append(r[0] if seg.squeeze else r)
        return results

    def run_rows(self, ys: Sequence[torch.Tensor],
                 eval_fn: Callable[[torch.Tensor], torch.Tensor]):
        batch, segments, _ = self.coalesce_rows(ys)
        return self.split_rows(eval_fn(batch), segments)
