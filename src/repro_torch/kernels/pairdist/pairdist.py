"""CUDA launch of the pairdist kernel (``csrc/pairdist.cu``).

The Hopper counterpart of ``pairdist_pallas``: D_ij = ‖u_i − u_j‖² for a
contiguous (C, P) CUDA tensor, f32/f64 in and out, bf16 in with f32 out.
Two routes, both hand-written kernels, chosen by shape
(:func:`pairdist_route`):

* ``"S"``, few conditions (bytes-bound): each block reads a contiguous
  column range of all C rows once (:func:`s_grid`), sums every pair
  product of it in registers, and a second pass sums the blocks' partials
  in a fixed order and writes the clamped distances. C <= :data:`S_MAX_C`.
* ``"T"``, many patterns (operation-bound): gram's tensor-core first pass
  (3×TF32 or bf16 ``wgmma``; DMMA for f64) with its split counts, then
  gram's reduce with the distance epilogue.

Both take the norms from the diagonal of their own product, so D is exactly
symmetric with an exactly zero diagonal.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, require_cuda, sm_count
from repro_torch.kernels.gram.gram import dmma_gram_splits, tc_gram_splits

SYMBOLS = {torch.float32: "pairdist_f32", torch.float64: "pairdist_f64",
           torch.bfloat16: "pairdist_bf16"}

#: The routes and their code in the C entry points.
ROUTES = {"S": 0, "T": 1}
#: Rows of route S's register tiles: a thread sums the 8 x 8 pairs of two row groups.
S_GROUP = 8
#: Route S's largest C: 136 upper tiles of 8-row groups, at least one thread each.
S_MAX_C = 128
#: Largest C that takes route S; above it, route T. From the sweep over
#: C = 8, 16, …, 256 at P = 76,000, f32 and f64, on an H100 (PERF.md §6):
#: S is faster up to C = 64, T from C = 128, in both dtypes.
S_THRESHOLD = 64
#: Route S's columns per block are a multiple of this: every block's range
#: starts on a 16-byte piece of every dtype (f32, f64 and bf16).
S_COL_ALIGN = 16
#: Route S's least columns per block, so that a short P is not cut into
#: slivers of a few pieces a block.
S_MIN_COLS = 256


def pairdist_route(c: int, p: int, dtype: torch.dtype) -> str:
    """``"S"`` for C <= :data:`S_THRESHOLD`, else ``"T"``: the measured
    crossover lies between C = 64 and 128 in f32 and in f64 alike, so the
    rule reads neither the dtype nor P (the sweep held P at 76,000)."""
    del p, dtype
    return "S" if c <= S_THRESHOLD else "T"


def s_grid(p: int, sms: int) -> tuple:
    """(blocks, columns per block) of route S: about one block per SM, each
    over a contiguous range of a whole number of S_COL_ALIGN columns and
    no fewer than S_MIN_COLS (P = 76,000 on 132 SMs: 132 blocks of 576
    columns). It does not depend on C: a block always reads all C rows."""
    cols = max(S_MIN_COLS, cdiv(cdiv(p, sms), S_COL_ALIGN) * S_COL_ALIGN)
    return cdiv(p, cols), cols


def s_workspace_entries(c: int) -> int:
    """Entries of one route-S block's partial: 64 for each upper tile of
    8-row groups."""
    g = cdiv(c, S_GROUP)
    return g * (g + 1) // 2 * S_GROUP * S_GROUP


def pairdist_cuda(u: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
    """Pairwise squared distances through the CUDA kernel; (C, C) in the
    accumulator dtype. ``route`` forces ``"S"`` or ``"T"`` (the route sweep
    and the card tests); ``None`` takes :func:`pairdist_route`'s."""
    require_cuda("pairdist", u)
    c, p = u.shape
    route = pairdist_route(c, p, u.dtype) if route is None else route
    acc = torch.float32 if u.dtype == torch.bfloat16 else u.dtype
    if route == "S":
        if c > S_MAX_C:
            raise ValueError(f"pairdist: route S takes C <= {S_MAX_C}, got {c}")
        blocks, parts = s_grid(p, sm_count(u.device))
        ws = torch.empty((blocks, s_workspace_entries(c)), dtype=acc, device=u.device)
    elif route == "T":
        splits = (dmma_gram_splits if u.dtype == torch.float64 else tc_gram_splits)
        parts = splits(c, p, sm_count(u.device))
        ws = torch.empty((parts, c, c), dtype=acc, device=u.device)
    else:
        raise ValueError(f"pairdist: route must be 'S' or 'T', got {route!r}")
    d = torch.empty((c, c), dtype=acc, device=u.device)
    _build.launch("pairdist", SYMBOLS[u.dtype], u.device, u, ws, d, c, p, ROUTES[route], parts)
    return d
