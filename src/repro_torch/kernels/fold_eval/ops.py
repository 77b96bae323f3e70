"""Public wrapper for the fused fold_eval kernel.

Carries the same residual-checked jitter retry as ``foldsolve`` (see
:mod:`repro_torch.kernels.foldsolve.ops`): a failing fold re-solves only
the fold-solve stage against the shifted system and the ê_Te it was first
solved against; the hat-row contraction is never repeated. On CUDA the
contraction, the solve, the check and the retry are one launch. A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fold_eval.fold_eval import fold_eval_cuda
from repro_torch.kernels.fold_eval.ref import fold_eval_checked_ref, fold_eval_ref

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
        if jitter:
            return fold_eval_checked_ref(h_rows, h_te, y, y_te)
        return fold_eval_ref(h_rows, h_te, y, y_te)[0]
    return fold_eval_cuda(h_rows, h_te, y, y_te, check=jitter == "auto")[0]
