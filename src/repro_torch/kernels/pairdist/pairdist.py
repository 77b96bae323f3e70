"""CUDA launch of the pairdist kernel (``csrc/pairdist.cu``).

The Hopper counterpart of ``pairdist_pallas``: D_ij = ‖u_i − u_j‖² for a
contiguous (C, P) CUDA tensor, f32/f64 in and out, bf16 in with f32 out.
The product is gram's split-contraction first pass (the split count is
:func:`repro_torch.kernels.gram.gram.gram_splits`'); the second pass takes
the norms from the summed diagonal of the same partials and writes the
clamped distances.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import require_cuda
from repro_torch.kernels.gram.gram import gram_splits

SYMBOLS = {torch.float32: "pairdist_f32", torch.float64: "pairdist_f64",
           torch.bfloat16: "pairdist_bf16"}


def pairdist_cuda(u: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances through the CUDA kernel; (C, C) in the
    accumulator dtype."""
    require_cuda("pairdist", u)
    c, p = u.shape
    acc = torch.float32 if u.dtype == torch.bfloat16 else u.dtype
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    splits = gram_splits(c, p, sms)
    ws = torch.empty((splits, c, c), dtype=acc, device=u.device)
    d = torch.empty((c, c), dtype=acc, device=u.device)
    _build.launch("pairdist", SYMBOLS[u.dtype], u.device, u, ws, d, c, p, splits)
    return d
