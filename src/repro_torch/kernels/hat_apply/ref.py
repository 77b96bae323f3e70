"""Plain PyTorch version of hat_apply: E = Y − H Y."""

import torch


def hat_apply_ref(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y - h @ y
