"""CUDA launch of the gram kernel (``csrc/gram.cu``).

The Hopper counterpart of ``gram_pallas``: G = X Xᵀ for a contiguous
(N, P) CUDA tensor, f32/f64 in and out, bf16 in with f32 out. The
contraction is split over ``splits`` blocks per output tile so that the
few tiles of a small N still fill the card; the split partials go to a
workspace this function allocates and are summed in a fixed order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, require_cuda

TILE = 64
#: Contraction columns below which a split is not worth its partial tile.
MIN_SPLIT_P = 1024

_SYMBOLS = {torch.float32: "gram_f32", torch.float64: "gram_f64",
            torch.bfloat16: "gram_bf16"}


def gram_splits(n: int, p: int, sms: int) -> int:
    """Contraction splits giving about two blocks per SM over the upper tiles."""
    tiles = cdiv(n, TILE)
    upper = tiles * (tiles + 1) // 2
    return max(1, min(cdiv(2 * sms, upper), cdiv(p, MIN_SPLIT_P)))


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """G = X Xᵀ through the CUDA kernel; (N, N) in the accumulator dtype."""
    require_cuda("gram", x)
    if x.ndim != 2:
        raise ValueError(f"gram: x must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"gram: unsupported dtype {x.dtype}")
    n, p = x.shape
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = gram_splits(n, p, sms)
    ws = torch.empty((splits, n, n), dtype=acc, device=x.device)
    g = torch.empty((n, n), dtype=acc, device=x.device)
    _build.launch("gram", _SYMBOLS[x.dtype], x.device, x, ws, g, n, p, splits)
    return g
