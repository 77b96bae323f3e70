"""Plain PyTorch version of the pairdist kernel, and an emulation of its
many-pattern route's epilogue for the tests."""

import torch


def pairwise_sq_dists_ref(u: torch.Tensor) -> torch.Tensor:
    """D_ij = max(‖u_i‖² + ‖u_j‖² − 2 u_i·u_j, 0); bf16/f16 inputs are cast
    to float32 first (and the result is float32)."""
    if u.dtype in (torch.bfloat16, torch.float16):
        u = u.float()
    n = (u * u).sum(dim=1)
    d = n[:, None] + n[None, :] - 2.0 * (u @ u.T)
    return torch.clamp(d, min=0.0)


def distance_from_partials_ref(ws: torch.Tensor) -> torch.Tensor:
    """Route T's second pass (``csrc/gram_reduce.cuh`` with the distance
    epilogue) in plain PyTorch, for the tests: the split partials
    ws (splits, C, C) summed in split order, G_ij read from the element
    upper triangle (i <= j), n_i = G_ii, and
    D_ij = max((n_i + n_j) − 2·G_ij, 0). The lower triangle of ws is never
    read, so D is exactly symmetric with a zero diagonal even where the
    partials are not symmetric (3×TF32 inside a diagonal tile)."""
    g = ws[0]
    for s in range(1, ws.shape[0]):
        g = g + ws[s]
    g = torch.triu(g) + torch.triu(g, diagonal=1).T
    n = torch.diagonal(g)
    return torch.clamp((n[:, None] + n[None, :]) - 2.0 * g, min=0.0)
