"""Operations and bytes that a kernel's job needs, from its shapes alone.

Each function returns the least time (seconds) the H100 could take for one
call: the larger of the operations over the published peak and the bytes
over the published HBM bandwidth (``h100.json``), with the name of the
bound. Bytes count each input read once and each output written once,
whatever the kernel reads again. Nothing here depends on how the program
implements the job.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "h100.json").read_text())


def _bound(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak, nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gram(n: int, p: int, itemsize: int = 4, peak: str = "tf32_flops") -> tuple[float, str]:
    """G = X Xᵀ for X (N, P): the N(N+1)/2 distinct entries at 2P operations
    each; X read once, G (N, N) written once."""
    return _bound(n * (n + 1) * p, PEAKS[peak], itemsize * (n * p + n * n))


def foldsolve(k: int, m: int, b: int, itemsize: int = 4,
              peak: str = "fp32_flops") -> tuple[float, str]:
    """(I − H_Te)⁻¹ E_Te for K folds of an (m, m) system with B right-hand
    sides: 2m³/3 + 2m²B operations a fold; H_Te and E read once, the
    solution written once."""
    ops = k * (2 * m ** 3 / 3 + 2 * m * m * b)
    return _bound(ops, PEAKS[peak], itemsize * k * (m * m + 2 * m * b))
