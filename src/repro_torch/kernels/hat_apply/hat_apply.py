"""CUDA launch of the hat_apply kernel (``csrc/hat_apply.cu``).

The Hopper counterpart of ``hat_apply_pallas``: E = Y − H·Y for contiguous
CUDA tensors H (N, N) and Y (N, B) of one dtype, both on the tensor cores:
f32 on ``wgmma`` (three TF32 products of a big + small split per step,
f32-grade) per 64 x 64 tile of E, f64 on the FP64 tensor cores by
``mma.sync`` (DMMA) per 64 x 64 tile. The contraction is split over
``hat_splits`` / ``dmma_hat_splits`` blocks per tile; the split partials go
to a workspace this function allocates and a second pass writes Y − their
sum, in a fixed order. With one split the first pass writes Y − H·Y itself.
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
#: Rows and columns of E per block of the f64 route.
DMMA_ROWS, DMMA_COLS = 64, 64
#: Blocks per SM the f64 route's splits may fill (three fit: 62 KB of
#: shared memory each).
DMMA_BLOCKS_PER_SM = 3
#: The f64 route's contraction chunk: a split takes a whole number of them.
DMMA_K = 16

_SYMBOLS = {torch.float32: "hat_apply_f32", torch.float64: "hat_apply_f64"}


def hat_splits(n: int, b: int, sms: int) -> int:
    """Contraction splits of the f32 route: as many as fit two blocks per SM
    (103 KB of shared memory each) over the tiles of E, so every block runs
    at once (13 x 4 tiles at N = 787, B = 250: 5 splits, 260 blocks), with
    no split shorter than MIN_SPLIT_N columns."""
    tiles = cdiv(n, TILE) * cdiv(b, TILE)
    return max(1, min(2 * sms // tiles, cdiv(n, MIN_SPLIT_N)))


def dmma_hat_splits(n: int, b: int, sms: int) -> int:
    """Contraction splits of the f64 route: as many as fit
    DMMA_BLOCKS_PER_SM blocks per SM over the 64 x 64 tiles of E, each
    split a whole number of DMMA_K-column chunks (lm_probe's N = 384,
    B = 64: 6 tiles, 24 splits, 144 blocks; N = 787 at B = 250: 52 tiles,
    7 splits; at B = 1: 13 tiles, 25 splits)."""
    tiles = cdiv(n, DMMA_ROWS) * cdiv(b, DMMA_COLS)
    want = max(1, min(DMMA_BLOCKS_PER_SM * sms // tiles, cdiv(n, DMMA_K)))
    return cdiv(n, DMMA_K * cdiv(cdiv(n, want), DMMA_K))


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
    splits = (hat_splits if f32 else dmma_hat_splits)(n, b, sm_count(dev))
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
