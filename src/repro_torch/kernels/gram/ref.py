"""Plain PyTorch versions of the gram kernel."""

import torch


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """G = X Xᵀ; bf16/f16 inputs accumulate (and return) in float32.

    Products of two bf16 values are exact in float32, so upcasting first
    gives the kernel's f32-accumulator numerics.
    """
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x @ x.T


def centered_gram_ref(x: torch.Tensor) -> torch.Tensor:
    return gram_ref(x - x.mean(dim=0, keepdim=True))
