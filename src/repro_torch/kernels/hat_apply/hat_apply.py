"""CUDA launch of the hat_apply kernel (``csrc/hat_apply.cu``).

The Hopper counterpart of ``hat_apply_pallas``: E = Y − H·Y for contiguous
CUDA tensors H (N, N) and Y (N, B) of one dtype. f32 runs on the tensor
cores (three TF32 products of a big + small split per step, f32-grade) with
the contraction split over ``hat_splits`` blocks per 64 x 64 tile of E; the
split partials go to a workspace this function allocates and a second pass
writes Y − their sum, in a fixed order. f64 runs the SIMT tile, one block
per tile, the subtraction fused into its store.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, require_cuda, sm_count

#: Rows and columns of E per block of the tensor-core route.
TILE = 64
#: Contraction columns below which a split is not worth its partial tile
#: (two chunks of 32).
MIN_SPLIT_N = 64

_SYMBOLS = {torch.float32: "hat_apply_f32", torch.float64: "hat_apply_f64"}


def hat_splits(n: int, b: int, sms: int) -> int:
    """Contraction splits of the f32 route: as many as fit two blocks per SM
    (103 KB of shared memory each) over the tiles of E, so every block runs
    at once (13 x 4 tiles at N = 787, B = 250: 5 splits, 260 blocks), with
    no split shorter than MIN_SPLIT_N columns."""
    tiles = cdiv(n, TILE) * cdiv(b, TILE)
    return max(1, min(2 * sms // tiles, cdiv(n, MIN_SPLIT_N)))


def hat_apply_cuda(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """E = Y − H Y through the CUDA kernel; y must be (N, B)."""
    require_cuda("hat_apply", h, y)
    n, b = y.shape
    if h.shape != (n, n):
        raise ValueError(f"hat_apply: h {tuple(h.shape)} does not match y {tuple(y.shape)}")
    if h.dtype not in _SYMBOLS or y.dtype != h.dtype:
        raise TypeError(f"hat_apply: unsupported dtypes h={h.dtype}, y={y.dtype}")
    dev, f32 = h.device, h.dtype == torch.float32
    h_ptr, y_ptr = h.data_ptr(), y.data_ptr()
    if f32 and (h_ptr % 16 or y_ptr % 16):
        raise ValueError("hat_apply: the f32 route copies H and Y in aligned 16-byte "
                         "pieces; their data must start 16-byte aligned")
    splits = hat_splits(n, b, sm_count(dev)) if f32 else 1
    # E and the (splits, N, B) workspace in one allocation, E first: one
    # allocator call less on a path that runs once per label chunk (E keeps
    # the workspace alive while it lives)
    extra = splits if splits > 1 else 0
    buf = torch.empty(((1 + extra) * n, b), dtype=h.dtype, device=dev)
    e = buf[:n]
    e_ptr = buf.data_ptr()
    ws = e_ptr + n * b * buf.element_size() if extra else None
    _build.launch("hat_apply", _SYMBOLS[h.dtype], dev, h_ptr, y_ptr, ws, e_ptr, n, b, splits)
    return e
