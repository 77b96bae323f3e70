"""Public wrapper for the permdraw kernel: checks and dispatch.

The CPU takes the plain version (``ref.py``); CUDA launches the kernel.
Both give the same rows bit for bit, so a draw does not depend on the
device it ran on.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.permdraw.permdraw import MAX_DIM, permdraw_cuda
from repro_torch.kernels.permdraw.ref import MASK32, permdraw_ref

__all__ = ["permdraw"]


def permdraw(key: tuple, t: int, n: int, *, device: torch.device) -> torch.Tensor:
    """(t, n) int64: t independent, exactly uniform permutations of 0..n-1.

    ``key`` is (k0, k1), two 32-bit words; row r depends on (key, r) only,
    so a larger t gives the same leading rows.
    """
    if not (0 <= t <= MAX_DIM and 0 <= n <= MAX_DIM):
        raise ValueError(f"permdraw: t and n must lie in [0, {MAX_DIM}], got t={t}, n={n}")
    if len(key) != 2 or not all(0 <= k <= MASK32 for k in key):
        raise ValueError(f"permdraw: key must be two 32-bit words, got {key}")
    device = torch.device(device)
    if device.type == "cpu":
        return permdraw_ref(key, t, n, device=device)
    return permdraw_cuda(key, t, n, device)
