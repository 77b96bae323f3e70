"""Public wrapper for the gram kernel: centering, precision, dispatch.

Also home of the ``precision="bf16_gram"`` build: the O(N²P) Gram product,
the only contraction over P in the dual path, is computed from a bf16 cast
of the *centered* design with float32 accumulation, then cast back to the
working dtype; every downstream solve stays full precision. The elementwise
bf16 rounding of X_c bounds the Gram's error by ~2·2⁻⁸ ‖X_c‖² (bf16 keeps
8 significand bits; the f32 accumulator adds O(P·2⁻²⁴)). Centering happens
*before* the cast: means are O(‖X‖) quantities whose bf16 rounding would
leak a rank-1 error of the size of the signal.

Dispatch: a CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel (``gram.py``) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gram.gram import gram_cuda
from repro_torch.kernels.gram.ref import gram_ref

__all__ = ["gram", "centered_gram", "centered_gram_plain", "check_precision",
           "PRECISIONS"]

#: Gram/hat build precisions: "fp32" = the working dtype end to end (the
#: name predates x64 configurations), "bf16_gram" = bf16 inputs with f32
#: accumulation for the Gram product only.
PRECISIONS = ("fp32", "bf16_gram")


def check_precision(precision: Optional[str]) -> str:
    """Normalise (None → "fp32") and validate a precision name."""
    precision = precision or "fp32"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return precision


def gram(x: torch.Tensor, *, center: bool = False,
         precision: Optional[str] = None) -> torch.Tensor:
    """G = X Xᵀ (optionally column-centered first), in the input dtype.

    ``precision="bf16_gram"`` casts the (centered) input to bf16 for the
    contraction, which accumulates in f32 (see the module docstring for
    the bound). The kernel masks ragged N and P itself: nothing is padded.
    """
    precision = check_precision(precision)
    if center:
        x = x - x.mean(dim=0, keepdim=True)
    out_dtype = x.dtype
    if precision == "bf16_gram":
        x = x.to(torch.bfloat16)
    g = gram_ref(x) if x.device.type == "cpu" else gram_cuda(x)
    return g.to(out_dtype)


def centered_gram(x: torch.Tensor, **kw) -> torch.Tensor:
    """Centered Gram G_c = X_c X_cᵀ — the dual hat-matrix building block."""
    return gram(x, center=True, **kw)


def centered_gram_plain(x: torch.Tensor, *,
                        precision: Optional[str] = None) -> torch.Tensor:
    """Centered Gram by plain PyTorch on any device (no kernel launch).

    The counterpart of the reference's ``centered_gram_xla``: at
    ``precision="bf16_gram"`` the centered design is cast to bf16 and
    contracted with a float32 accumulator, then cast back.
    """
    precision = check_precision(precision)
    xc = x - x.mean(dim=0, keepdim=True)
    if precision == "fp32":
        return xc @ xc.T
    return gram_ref(xc.to(torch.bfloat16)).to(x.dtype)
