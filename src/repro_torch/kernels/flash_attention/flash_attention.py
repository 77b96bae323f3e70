"""CUDA launch of the flash_attention kernel (``csrc/flash_attention.cu``).

The Hopper counterpart of ``flash_attention_pallas``: causal / windowed /
soft-capped GQA self-attention with an online softmax, f32 math, f32 or
bf16 in and out. Two routes, by dtype: bf16 runs on the tensor cores
(wgmma, TMA, P split into two bf16 halves), f32 on the SIMT cores. q, k and
v are read through their strides (the feature dimension must be
contiguous), so a transposed view of the projections' (B, S, H, D) layout
goes in without a copy; the output is allocated with q's strides.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

SYMBOLS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
#: The kernel each dtype runs.
ROUTES = {torch.float32: "simt", torch.bfloat16: "tensor_core"}
#: Head dimensions the kernel is instantiated for.
HEAD_DIMS = (64, 128, 256)
#: Query rows per block and keys per tile of each route (kFlashBQ / kFlashBK
#: and kTcBQ / kTcBK in the source).
TILES = {"simt": (64, 64), "tensor_core": (128, 64)}
_INT_MAX = 2**31 - 1


def key_tile_range(q0: int, s: int, window: Optional[int], causal: bool,
                   tile: tuple) -> tuple:
    """The first and last key tile (inclusive) the kernel visits for the
    query block starting at ``q0``, with ``tile`` = (query rows, keys) of the
    route: from max(0, q0 − W + 1) to the causal frontier. Mirrors the loop
    bounds in ``csrc/flash_attention.cu``."""
    bq, bk = tile
    hi = (min(q0 + bq, s) - 1 if causal else s - 1) // bk
    lo = 0 if window is None else max(0, q0 - window + 1) // bk
    return lo, hi


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                         causal: bool, window: Optional[int],
                         softcap: Optional[float]) -> torch.Tensor:
    """Attention through the CUDA kernel; checked shapes, one launch."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: kernel route needs CUDA tensors on one device, "
                             f"got {name} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s feature dimension must be contiguous")
        if max(t.stride()[:3]) > _INT_MAX:
            raise ValueError(f"flash_attention: {name}'s strides exceed 32 bits")
    b, hq, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B·Hq = {b * hq} exceeds the grid's 65,535")
    if q.dtype == torch.bfloat16:
        # TMA reads 16-byte aligned rows: base and every stride of an axis
        # longer than 1 a multiple of 16 bytes
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                                        if n > 1):
                raise ValueError(f"flash_attention: the bf16 route needs {name} 16-byte "
                                 f"aligned with strides that are multiples of 8 elements, "
                                 f"got strides {t.stride()}")
    out = torch.empty_like(q)                  # q's strides (a dense layout)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    _build.launch("flash_attention", SYMBOLS[q.dtype], q.device, q, k, v, out,
                  b, hq, k.shape[1], s, d, *strides, float(scale),
                  0.0 if softcap is None else float(softcap), int(causal),
                  0 if window is None else int(window))
    return out
