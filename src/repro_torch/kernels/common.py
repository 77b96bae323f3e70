"""Shared helpers for the Hopper kernels and the entry points that place tensors.

Two rules hold across the package:

* **Device rule.** An entry point that creates tensors takes ``device=None``,
  which means ``"cuda"``; :func:`resolve_device` raises when no card is
  present and the caller did not ask for the CPU. Nothing quietly runs on
  the CPU. Functions that take tensors follow the device of their inputs.
* **Kernel dispatch rule.** Each ``kernels/<name>/ops.py`` wrapper takes its
  plain PyTorch version only for a CPU tensor; for a CUDA tensor it launches
  the hand-written kernel or raises. :func:`default_fused` resolves the
  ``fused=None`` default the same way: the kernel route on CUDA, the
  reference's Cholesky composite on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

__all__ = ["cdiv", "default_fused", "resolve_device", "require_cuda", "sm_count"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; raise if the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def default_fused(device: Union[str, torch.device]) -> bool:
    """Resolve ``fused=None``: the kernel route on CUDA, the composite on CPU."""
    return torch.device(device).type == "cuda"


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device.

    Called by each wrapper on its kernel route, so a tensor on another
    device (or a strided view) is refused instead of reaching the launch.
    """
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: kernel route needs CUDA tensors on one "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel route needs contiguous tensors")
