"""CUDA launch of the permdraw kernel (``csrc/permdraw.cu``).

Replaces no TPU kernel (the JAX package draws with ``jax.random``): all
rows of a permutation test's draws in one launch, from a 64-bit key, with
no state and no host work a row. One thread shuffles one row; a block of 32
rows stages them as int16 in shared memory and writes them out coalesced
while 32 rows of N fit (N ≤ 3,632), and shuffles them in place in the
output above that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: The entry point's largest t and n (C ints).
MAX_DIM = 2 ** 31 - 1


def permdraw_cuda(key: tuple, t: int, n: int, device: torch.device) -> torch.Tensor:
    """(t, n) int64 on ``device`` (CUDA): one launch, none for an empty result."""
    out = torch.empty((t, n), dtype=torch.int64, device=device)
    if t and n:
        _build.launch("permdraw", "permdraw", out.device, out, key[0], key[1], t, n)
    return out
