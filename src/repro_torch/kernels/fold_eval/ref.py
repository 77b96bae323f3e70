"""Plain PyTorch versions of the fused fold_eval kernel."""

import torch

from repro_torch.kernels.foldsolve.ref import gauss_jordan_solve, jitter_retry_ref


def fold_eval_ref(h_rows: torch.Tensor, h_te: torch.Tensor, y: torch.Tensor,
                  y_te: torch.Tensor):
    """Returns (ė_Te, ê_Te), both (K, m, B): the hat-row contraction, then
    the step-for-step Gauss–Jordan solve the kernel's epilogue runs."""
    e = y_te - torch.matmul(h_rows, y)
    eye = torch.eye(h_te.shape[-1], dtype=h_te.dtype, device=h_te.device)
    return gauss_jordan_solve(eye - h_te, e), e


def fold_eval_checked_ref(h_rows: torch.Tensor, h_te: torch.Tensor, y: torch.Tensor,
                          y_te: torch.Tensor) -> torch.Tensor:
    """ė_Te of the checked solve: each fold that fails the residual check is
    solved again against the shifted system and its ê (the reference's
    ``fold_eval(..., jitter="auto")``)."""
    t, e = fold_eval_ref(h_rows, h_te, y, y_te)
    return jitter_retry_ref(h_te, e, t)
