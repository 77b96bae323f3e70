"""Plain PyTorch version of the pairdist kernel."""

import torch


def pairwise_sq_dists_ref(u: torch.Tensor) -> torch.Tensor:
    """D_ij = max(‖u_i‖² + ‖u_j‖² − 2 u_i·u_j, 0); bf16/f16 inputs are cast
    to float32 first (and the result is float32)."""
    if u.dtype in (torch.bfloat16, torch.float16):
        u = u.float()
    n = (u * u).sum(dim=1)
    d = n[:, None] + n[None, :] - 2.0 * (u @ u.T)
    return torch.clamp(d, min=0.0)
