"""CUDA launch of the gram kernel (``csrc/gram.cu``).

The Hopper counterpart of ``gram_pallas``: G = X Xᵀ for a contiguous
(N, P) CUDA tensor, f32/f64 in and out, bf16 in with f32 out. f32 and bf16
run on the tensor cores (128-row tiles, ``csrc/upper_gram_tc.cuh``; f32 as
three TF32 products of a big + small split), f64 on the SIMT tile (64-row
tiles, ``csrc/upper_gram.cuh``). The contraction is split over ``splits``
blocks per output tile so that the few tiles of a small N still fill the
card; the split partials go to a workspace this function allocates and are
summed in a fixed order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, require_cuda, sm_count

#: Output tile rows of the SIMT route (f64, and pairdist's first pass).
TILE = 64
#: Output tile rows of the tensor-core route (f32, bf16).
TC_TILE = 128
#: Waves of one block per SM the tensor-core route's split count may fill.
TC_WAVES = 3
#: Contraction columns below which a split is not worth its partial tile.
MIN_SPLIT_P = 1024

_SYMBOLS = {torch.float32: "gram_f32", torch.float64: "gram_f64",
            torch.bfloat16: "gram_bf16"}


def gram_splits(n: int, p: int, sms: int) -> int:
    """Contraction splits giving about two blocks per SM over the upper tiles."""
    tiles = cdiv(n, TILE)
    upper = tiles * (tiles + 1) // 2
    return max(1, min(cdiv(2 * sms, upper), cdiv(p, MIN_SPLIT_P)))


def tc_gram_splits(n: int, p: int, sms: int) -> int:
    """Contraction splits of the tensor-core route: one block fits an SM
    (225 KB of shared memory at f32), so the count is the largest that
    fills at most TC_WAVES whole waves over the upper tiles (28 at N = 787:
    14 splits, 392 blocks for 396 slots), and no split gets fewer than
    MIN_SPLIT_P columns."""
    tiles = cdiv(n, TC_TILE)
    upper = tiles * (tiles + 1) // 2
    return max(1, min(TC_WAVES * sms // upper, cdiv(p, MIN_SPLIT_P)))


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """G = X Xᵀ through the CUDA kernel; (N, N) in the accumulator dtype."""
    require_cuda("gram", x)
    if x.ndim != 2:
        raise ValueError(f"gram: x must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"gram: unsupported dtype {x.dtype}")
    n, p = x.shape
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    split_rule = gram_splits if x.dtype == torch.float64 else tc_gram_splits
    splits = split_rule(n, p, sm_count(x.device))
    ws = torch.empty((splits, n, n), dtype=acc, device=x.device)
    g = torch.empty((n, n), dtype=acc, device=x.device)
    _build.launch("gram", _SYMBOLS[x.dtype], x.device, x, ws, g, n, p, splits)
    return g
