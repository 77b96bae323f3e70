"""Public wrapper for the fused fold_eval kernel.

Carries the same residual-checked jitter retry as ``foldsolve`` (see
:mod:`repro_torch.kernels.foldsolve.ops`): the fused kernel also returns
the ê_Te block it solved against, so a failing fold re-solves only the
fold-solve stage, through the foldsolve kernel, against the shifted
system; the hat-row contraction is never repeated. A CPU tensor takes the
plain version (``ref.py``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fold_eval.fold_eval import fold_eval_cuda
from repro_torch.kernels.fold_eval.ref import fold_eval_ref
from repro_torch.kernels.foldsolve.ops import jitter_retry

__all__ = ["fold_eval"]


def fold_eval(h_rows: torch.Tensor, h_te: torch.Tensor, y: torch.Tensor,
              y_te: torch.Tensor, *, jitter: Optional[str] = "auto") -> torch.Tensor:
    """Fused ė_Te = (I − H_Te)⁻¹ (y_Te − H·y) for all folds in one launch.

    h_rows: (K, m, N) per-fold hat rows H[te_k, :].
    h_te:   (K, m, m) diagonal fold blocks H_Te.
    y:      (N, B) label batch.   y_te: (K, m, B) gathered test labels.
    Returns ė_Te of shape (K, m, B). ``jitter`` as in ``foldsolve``.
    """
    if jitter not in ("auto", None):
        raise ValueError(f"jitter must be 'auto' or None, got {jitter!r}")
    if h_rows.device.type == "cpu":
        t, e = fold_eval_ref(h_rows, h_te, y, y_te)
    else:
        t, e = fold_eval_cuda(h_rows, h_te, y, y_te)
    if jitter == "auto":
        t = jitter_retry(h_te, e, t)
    return t
