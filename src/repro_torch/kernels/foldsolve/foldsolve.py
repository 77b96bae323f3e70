"""CUDA launch of the foldsolve kernel (``csrc/foldsolve.cu``).

The Hopper counterpart of ``foldsolve_pallas``: solves (I − H_Te[k]) X = E[k]
for every fold by pivot-free Gauss–Jordan, one block per (fold, tile of
``bb`` right-hand sides). The augmented (m, m + bb) block lives in shared
memory while it fits in the card's 227 KB; above that the same kernel runs
on a global-memory scratch this function allocates.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, require_cuda

#: Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_BYTES = 232448
#: Right-hand-side columns per block.
BLOCK_B = 64

_SYMBOLS = {torch.float32: "foldsolve_f32", torch.float64: "foldsolve_f64"}


def block_cols(b: int) -> int:
    return min(BLOCK_B, b)


def aug_in_shared(m: int, bb: int, itemsize: int) -> bool:
    """Whether [A | E_tile] plus the pivot buffers fit in shared memory."""
    return (m * (m + bb) + 2 * m + bb) * itemsize <= SMEM_BYTES


def aug_scratch(k: int, m: int, b: int, bb: int, like: torch.Tensor) -> Optional[torch.Tensor]:
    """Global-memory home for the augmented blocks when shared memory is too small."""
    if aug_in_shared(m, bb, like.element_size()):
        return None
    return torch.empty((k, cdiv(b, bb), m, m + bb), dtype=like.dtype, device=like.device)


def foldsolve_cuda(h_te: torch.Tensor, e: torch.Tensor, *,
                   shift: Optional[torch.Tensor] = None,
                   bad: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve every fold; h_te (K, m, m), e (K, m, B) → (K, m, B).

    With ``shift`` (K,) and ``bad`` (K,) bool, only the bad folds are solved
    again, against I − (H_Te − shift·I), into ``out`` in place; the other
    folds' blocks return at once.
    """
    require_cuda("foldsolve", h_te, e,
                 *(t for t in (shift, bad, out) if t is not None))
    k, m, b = e.shape
    if h_te.shape != (k, m, m):
        raise ValueError(f"foldsolve: h_te {tuple(h_te.shape)} does not match e {tuple(e.shape)}")
    if h_te.dtype not in _SYMBOLS or e.dtype != h_te.dtype:
        raise TypeError(f"foldsolve: unsupported dtypes h_te={h_te.dtype}, e={e.dtype}")
    if (shift is None) != (bad is None):
        raise ValueError("foldsolve: shift and bad go together")
    if bad is not None and (bad.dtype != torch.bool or bad.shape != (k,)
                            or shift.shape != (k,) or shift.dtype != h_te.dtype):
        raise ValueError("foldsolve: shift must be (K,) of h_te's dtype, bad (K,) bool")
    if out is None:
        out = torch.empty_like(e)
    elif out.shape != e.shape or out.dtype != e.dtype:
        raise ValueError("foldsolve: out must match e")
    bb = block_cols(b)
    scratch = aug_scratch(k, m, b, bb, e)
    _build.launch("foldsolve", _SYMBOLS[h_te.dtype], h_te.device,
                  h_te, e, shift, bad, out, scratch, k, m, b, bb)
    return out
