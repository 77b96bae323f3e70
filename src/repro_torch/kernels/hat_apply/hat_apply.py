"""CUDA launch of the hat_apply kernel (``csrc/hat_apply.cu``).

The Hopper counterpart of ``hat_apply_pallas``: E = Y − H·Y for contiguous
CUDA tensors H (N, N) and Y (N, B) of one dtype (f32 or f64), accumulated
in that dtype, with the subtraction fused into the kernel's store.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import require_cuda

_SYMBOLS = {torch.float32: "hat_apply_f32", torch.float64: "hat_apply_f64"}


def hat_apply_cuda(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """E = Y − H Y through the CUDA kernel; y must be (N, B)."""
    require_cuda("hat_apply", h, y)
    n, b = y.shape
    if h.shape != (n, n):
        raise ValueError(f"hat_apply: h {tuple(h.shape)} does not match y {tuple(y.shape)}")
    if h.dtype not in _SYMBOLS or y.dtype != h.dtype:
        raise TypeError(f"hat_apply: unsupported dtypes h={h.dtype}, y={y.dtype}")
    e = torch.empty_like(y)
    _build.launch("hat_apply", _SYMBOLS[h.dtype], h.device, h, y, e, n, b)
    return e
