"""CUDA launch of the fused fold_eval kernel (``csrc/fold_eval.cu``).

The Hopper counterpart of ``fold_eval_pallas`` and its wrapper's retry: one
thread block cluster per fold, whose blocks take tiles of ``bb`` columns
of Y. Each block contracts H[te_k, :]·Y_tile through shared memory, forms
ê_Te = y_Te − H·Y and solves (I − H_Te) ė = ê with foldsolve's core; with
``check`` the same launch checks each fold's residual and re-solves a
failing fold against the ê it wrote (the contraction is not repeated).
Register, shared or global placement of the augmented block follows
foldsolve's rule.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import require_cuda
from repro_torch.kernels.foldsolve.foldsolve import aug_scratch, block_cols

_SYMBOLS = {torch.float32: "fold_eval_f32", torch.float64: "fold_eval_f64"}


def fold_eval_cuda(h_rows: torch.Tensor, h_te: torch.Tensor, y: torch.Tensor,
                   y_te: torch.Tensor, *, check: bool):
    """(ė_Te, ê_Te, bad) for h_rows (K, m, N), h_te (K, m, m), y (N, B),
    y_te (K, m, B), in one launch; bad as in ``foldsolve_cuda``."""
    require_cuda("fold_eval", h_rows, h_te, y, y_te)
    k, m, n = h_rows.shape
    b = y.shape[1]
    if h_te.shape != (k, m, m) or y.shape != (n, b) or y_te.shape != (k, m, b):
        raise ValueError("fold_eval: shapes do not agree: h_rows "
                         f"{tuple(h_rows.shape)}, h_te {tuple(h_te.shape)}, "
                         f"y {tuple(y.shape)}, y_te {tuple(y_te.shape)}")
    dtype = h_rows.dtype
    if dtype not in _SYMBOLS or any(t.dtype != dtype for t in (h_te, y, y_te)):
        raise TypeError(f"fold_eval: inputs must share one dtype of {list(_SYMBOLS)}")
    t = torch.empty_like(y_te)
    e = torch.empty_like(y_te)
    bad = torch.empty(k, dtype=torch.bool, device=y_te.device) if check else None
    bb = block_cols(b)
    scratch = aug_scratch(k, m, b, bb, y_te)
    _build.launch("fold_eval", _SYMBOLS[dtype], h_rows.device,
                  h_rows, h_te, y, y_te, t, e, bad, scratch, k, m, n, b, bb)
    return t, e, bad
