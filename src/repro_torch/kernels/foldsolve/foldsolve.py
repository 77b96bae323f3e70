"""CUDA launch of the foldsolve kernel (``csrc/foldsolve.cu``).

The Hopper counterpart of ``foldsolve_pallas`` and its wrapper's retry:
solves (I − H_Te[k]) X = E[k] for every fold by pivot-free Gauss–Jordan,
one thread block cluster per fold whose blocks take tiles of ``bb``
right-hand sides. With ``check`` the same launch measures each fold's
residual and solves a failing fold again, whole, against the shifted
system (``csrc/gauss_jordan.cuh``). The elimination holds its entries in
registers for m ≤ 80 (with m + bb ≤ 160), else in shared memory while the
augmented (m, m + bb) block fits in the card's 227 KB; above that it runs
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
#: Blocks of one fold's cluster; a block walks its tiles beyond that.
CLUSTER_BLOCKS = 8
#: Elements of the kernel's reduction scratch (gauss_jordan.cuh kRedElems).
_RED_ELEMS = 3 * 32 + 4

_SYMBOLS = {torch.float32: "foldsolve_f32", torch.float64: "foldsolve_f64"}


def block_cols(b: int, block: Optional[int] = None) -> int:
    """Tile width: ``block`` (default :data:`BLOCK_B`) columns, at most B."""
    return min(block or BLOCK_B, b)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def aug_in_shared(m: int, bb: int, itemsize: int) -> bool:
    """Whether [A | E_tile] plus the row, factor and reduction buffers fit
    in shared memory (``gauss_jordan.cuh::fold_layout``, shared route)."""
    w = m + bb
    elems = _round4(2 * w) + _round4(2 * m) + _round4(_RED_ELEMS) + _round4(m * w)
    return elems * itemsize <= SMEM_BYTES


def aug_scratch(k: int, m: int, b: int, bb: int, like: torch.Tensor) -> Optional[torch.Tensor]:
    """Global-memory home for each block's augmented block when shared memory
    is too small: (K, blocks of a fold, m, m + bb)."""
    if aug_in_shared(m, bb, like.element_size()):
        return None
    blocks = min(cdiv(b, bb), CLUSTER_BLOCKS)
    return torch.empty((k, blocks, m, m + bb), dtype=like.dtype, device=like.device)


def foldsolve_cuda(h_te: torch.Tensor, e: torch.Tensor, *, check: bool,
                   block: Optional[int] = None):
    """Solve every fold in one launch; h_te (K, m, m), e (K, m, B).

    Returns ``(out, bad)``: out (K, m, B); with ``check``, bad is the (K,)
    bool of folds that failed the residual check and were solved again
    against I − (H_Te − ε_k I), else None (no check, no retry). ``block``
    overrides the tile width.
    """
    require_cuda("foldsolve", h_te, e)
    k, m, b = e.shape
    if h_te.shape != (k, m, m):
        raise ValueError(f"foldsolve: h_te {tuple(h_te.shape)} does not match e {tuple(e.shape)}")
    if h_te.dtype not in _SYMBOLS or e.dtype != h_te.dtype:
        raise TypeError(f"foldsolve: unsupported dtypes h_te={h_te.dtype}, e={e.dtype}")
    out = torch.empty_like(e)
    bad = torch.empty(k, dtype=torch.bool, device=e.device) if check else None
    bb = block_cols(b, block)
    scratch = aug_scratch(k, m, b, bb, e)
    _build.launch("foldsolve", _SYMBOLS[h_te.dtype], h_te.device,
                  h_te, e, out, bad, scratch, k, m, b, bb)
    return out, bad
