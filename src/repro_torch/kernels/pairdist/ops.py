"""Public wrapper for the pairdist kernel: checks and dispatch.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel on the route its shape takes (``pairdist.py``: few conditions
bytes-bound, many patterns on gram's tensor-core passes) or raises. Ragged C and P are masked inside
the kernel, so nothing is padded; the TPU kernel's lane-replicated
(C, 128) norms input has no counterpart (the kernel takes the norms from
the diagonal of its own product).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pairdist.pairdist import SYMBOLS, pairdist_cuda
from repro_torch.kernels.pairdist.ref import pairwise_sq_dists_ref

__all__ = ["pairwise_sq_dists"]


def pairwise_sq_dists(u: torch.Tensor) -> torch.Tensor:
    """D[i, j] = ‖u_i − u_j‖² for row patterns U (C, P), clamped at 0.

    f32 and f64 return their own dtype; bf16 accumulates and returns f32.
    Any other dtype raises ``TypeError``.
    """
    if u.ndim != 2:
        raise ValueError(f"pairdist: u must be 2-D, got shape {tuple(u.shape)}")
    if u.dtype not in SYMBOLS:
        raise TypeError(f"pairdist: unsupported dtype {u.dtype} "
                        "(float32, float64 or bfloat16)")
    return pairwise_sq_dists_ref(u) if u.device.type == "cpu" else pairdist_cuda(u)
