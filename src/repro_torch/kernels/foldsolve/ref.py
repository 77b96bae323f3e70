"""Plain PyTorch versions of foldsolve: the step-for-step Gauss–Jordan, the
residual check and the jitter retry (the checked solve)."""

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


def _residual_tol(dtype: torch.dtype) -> float:
    """√ε acceptance threshold: far above a healthy solve's ~ε·m residual,
    far below the O(1) residual of a degenerate pivot-free elimination."""
    return float(torch.finfo(dtype).eps) ** 0.5


def _eye_minus(h_te: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(h_te.shape[-1], dtype=h_te.dtype, device=h_te.device)
    return eye - h_te


def fold_jitter(h_te: torch.Tensor) -> torch.Tensor:
    """Per-fold Tikhonov shift ε_k = √ε·(1 + ‖I − H_Te[k]‖_max)."""
    a = _eye_minus(h_te)
    return _residual_tol(h_te.dtype) * (1.0 + a.abs().amax(dim=(1, 2)))


def fold_residual_bad(h_te: torch.Tensor, t: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(K,) bool: folds whose solve t of (I − H_Te) t = e failed the
    residual check (or produced non-finite values)."""
    r = torch.bmm(_eye_minus(h_te), t) - e
    scale = 1.0 + e.abs().amax(dim=(1, 2))
    finite = torch.isfinite(t).all(dim=2).all(dim=1)
    # NaN propagates through amax; comparisons with NaN are False, so the
    # finiteness term (not the residual term) must catch that case.
    resid_ok = r.abs().amax(dim=(1, 2)) <= _residual_tol(e.dtype) * scale
    return ~(finite & resid_ok)


def jitter_retry_ref(h_te: torch.Tensor, e: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` with each fold that fails the residual check solved again, whole,
    against I − (H_Te − ε_k I); a healthy fold keeps its solve bit for bit."""
    bad = fold_residual_bad(h_te, t, e)
    if not bool(bad.any()):
        return t
    shift = fold_jitter(h_te)
    eye = torch.eye(h_te.shape[-1], dtype=h_te.dtype, device=h_te.device)
    t = t.clone()
    t[bad] = foldsolve_ref(h_te[bad] - shift[bad, None, None] * eye, e[bad])
    return t


def foldsolve_checked_ref(h_te: torch.Tensor, e_te: torch.Tensor) -> torch.Tensor:
    """The checked solve the kernel runs with ``check``: solve, check each
    fold's residual, solve the failing folds again against the shifted
    system (the reference's ``foldsolve(..., jitter="auto")``)."""
    return jitter_retry_ref(h_te, e_te, foldsolve_ref(h_te, e_te))
