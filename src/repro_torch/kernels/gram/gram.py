"""CUDA launch of the gram kernel (``csrc/gram.cu``).

The Hopper counterpart of ``gram_pallas``: G = X Xᵀ for a contiguous
(N, P) CUDA tensor, f32/f64 in and out, bf16 in with f32 out. Every dtype
runs on the tensor cores in 128-row tiles: f32 and bf16 on ``wgmma``
(``csrc/upper_gram_tc.cuh``; f32 as three TF32 products of a big + small
split), f64 on the FP64 tensor cores by ``mma.sync`` (DMMA,
``csrc/upper_gram_dmma.cuh``; f64 products need no split). The contraction
is split over ``splits`` blocks per output tile so that the few tiles of a
small N still fill the card; the split partials go to a workspace this
function allocates and are summed in a fixed order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, require_cuda, sm_count

#: Output tile rows of the tensor-core routes (f32 and bf16 on wgmma, f64 on DMMA).
TC_TILE = 128
#: Waves of one block per SM the tensor-core routes' split counts may fill.
TC_WAVES = 3
#: Contraction columns below which a split is not worth its partial tile.
MIN_SPLIT_P = 1024
#: The f64 route's least contraction per split: four chunks of 16 columns
#: (its blocks are short at the probe's P = 2,304, so the split goes finer).
DMMA_MIN_SPLIT_P = 64
#: The f64 route's contraction chunk: a split takes a whole number of them.
DMMA_K = 16

_SYMBOLS = {torch.float32: "gram_f32", torch.float64: "gram_f64",
            torch.bfloat16: "gram_bf16"}


def tc_gram_splits(n: int, p: int, sms: int) -> int:
    """Contraction splits of the tensor-core route: one block fits an SM
    (225 KB of shared memory at f32), so the count is the largest that
    fills at most TC_WAVES whole waves over the upper tiles (28 at N = 787:
    14 splits, 392 blocks for 396 slots), and no split gets fewer than
    MIN_SPLIT_P columns."""
    tiles = cdiv(n, TC_TILE)
    upper = tiles * (tiles + 1) // 2
    return max(1, min(TC_WAVES * sms // upper, cdiv(p, MIN_SPLIT_P)))


def dmma_gram_splits(n: int, p: int, sms: int) -> int:
    """Contraction splits of the f64 route: one block fits an SM (192 KB of
    shared memory, 64 accumulators a thread), so the count fills whole
    waves over the upper 128-row tiles: TC_WAVES where P is long enough
    (28 tiles at N = 787: 14 splits, 392 blocks for 396 slots), else the
    one wave that splits of at least DMMA_MIN_SPLIT_P columns can fill
    (6 tiles at N = 384, P = 2,304: 22 splits asked, 21 of whole 16-column
    chunks, 126 blocks)."""
    tiles = cdiv(n, TC_TILE)
    upper = tiles * (tiles + 1) // 2
    most = cdiv(p, DMMA_MIN_SPLIT_P)
    waves = max(1, min(TC_WAVES, most * upper // sms))
    want = max(1, min(most, waves * sms // upper))
    return cdiv(p, DMMA_K * cdiv(cdiv(p, want), DMMA_K))


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """G = X Xᵀ through the CUDA kernel; (N, N) in the accumulator dtype."""
    require_cuda("gram", x)
    if x.ndim != 2:
        raise ValueError(f"gram: x must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"gram: unsupported dtype {x.dtype}")
    n, p = x.shape
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    f64 = x.dtype == torch.float64
    splits = (dmma_gram_splits if f64 else tc_gram_splits)(n, p, sm_count(x.device))
    ws = torch.empty((splits, n, n), dtype=acc, device=x.device)
    g = torch.empty((n, n), dtype=acc, device=x.device)
    _build.launch("gram", _SYMBOLS[x.dtype], x.device, x, ws, g, n, p, splits)
    return g
