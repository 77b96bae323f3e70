"""Plain PyTorch versions of foldsolve: the step-for-step Gauss–Jordan."""

import torch


def gauss_jordan_solve(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Solve A X = E per fold by pivot-free Gauss–Jordan, as the kernel does.

    a: (K, m, m), e: (K, m, B). Each of the m steps normalises the pivot
    row and applies one rank-1 update to the augmented (K, m, m + B) block,
    product and subtraction rounded separately — the kernel's arithmetic.
    """
    m = a.shape[-1]
    aug = torch.cat([a, e.to(a.dtype)], dim=-1)
    for i in range(m):
        row_n = aug[:, i, :] / aug[:, i, i:i + 1]
        fac = aug[:, :, i].clone()
        fac[:, i] = 0.0
        aug = aug - fac[:, :, None] * row_n[:, None, :]
        aug[:, i, :] = row_n
    return aug[:, :, m:]


def foldsolve_ref(h_te: torch.Tensor, e_te: torch.Tensor) -> torch.Tensor:
    """(I − H_Te[k])⁻¹ E[k] for every fold; h_te (K, m, m), e_te (K, m, B)."""
    eye = torch.eye(h_te.shape[-1], dtype=h_te.dtype, device=h_te.device)
    return gauss_jordan_solve(eye - h_te, e_te)
