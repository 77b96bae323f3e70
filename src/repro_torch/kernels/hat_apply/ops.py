"""Public wrapper for hat_apply: shape handling and dispatch.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel (``hat_apply.py``) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hat_apply.hat_apply import hat_apply_cuda
from repro_torch.kernels.hat_apply.ref import hat_apply_ref

__all__ = ["hat_errors"]


def hat_errors(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ê = y − H y for a label batch y (N,) or (N, B) — Algorithm 1 inner step."""
    squeeze = y.ndim == 1
    yb = y[:, None] if squeeze else y
    e = hat_apply_ref(h, yb) if h.device.type == "cpu" else hat_apply_cuda(h, yb)
    return e[:, 0] if squeeze else e
