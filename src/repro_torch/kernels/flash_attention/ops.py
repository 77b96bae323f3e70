"""Public wrapper for the flash_attention kernel: checks and dispatch.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel (``flash_attention.py``) or raises. Unlike the TPU wrapper it
pads nothing: ragged S is masked inside the kernel. The inputs are not
made contiguous either: the kernel reads them through their strides.

On the card the launch is the operator ``repro_torch::flash_attention``
(:func:`flash_attention_op`), so a gradient flows through the kernel's
output: its forward is the kernel, its backward the exact gradient of the
same function, taken by recomputing the plain version on the saved q, k
and v. The JAX package has no backward kernel (its training differentiates
the plain attention), so the port has none either: the backward is plain
PyTorch. Being an operator, a launch is visible to a dispatch mode by name
(``launch.step_analysis`` counts it there).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels.flash_attention.flash_attention import SYMBOLS, flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention_op", "flash_attention"]

#: The forward launch of :func:`flash_attention_op` (the CUDA kernel).
_kernel = flash_attention_cuda


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                       causal: bool, window: Optional[int],
                       softcap: Optional[float]) -> torch.Tensor:
    """The kernel's output with a gradient. Forward: one launch of the
    kernel. Backward (:func:`_backward`): ``attention_ref`` recomputed on
    the saved q, k, v under ``torch.enable_grad()`` and differentiated by
    ``torch.autograd.grad`` (f32 logits (B, Hq, S, S) per call), the exact
    gradient of the function the kernel computes. It launches nothing: a
    Hopper backward kernel is later work."""
    return _kernel(q, k, v, scale=scale, causal=causal, window=window, softcap=softcap)


def _setup_context(ctx, inputs, output):
    q, k, v, scale, causal, window, softcap = inputs
    ctx.save_for_backward(q, k, v)
    ctx.kw = {"scale": scale, "causal": causal, "window": window, "softcap": softcap}


def _backward(ctx, dout):
    """The recompute of the forward runs outside every dispatch mode: a mode
    sees the launch (the operator) and the gradient's products, as it sees
    autograd through ``attention_ref`` on the CPU, and not the forward a
    second time."""
    saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad(), _disable_current_modes():
        out = attention_ref(*saved, **ctx.kw)
    dq, dk, dv = torch.autograd.grad(out, saved, dout)
    return dq, dk, dv, None, None, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Self-attention (S_q == S_kv). q: (B, Hq, S, D); k, v: (B, Hkv, S, D)
    with Hq % Hkv == 0; query head h reads KV head h // (Hq / Hkv).

    float32 and bfloat16 only (math in float32, output in the input type);
    any other dtype raises ``TypeError``. On the card the output carries a
    gradient to q, k and v (:func:`flash_attention_op`).
    """
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention: need 4-D q and equal 4-D k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (self-attention with Hq % Hkv == 0)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in SYMBOLS:
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                        "(float32 or bfloat16, all alike)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be ≥ 1, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the kernel route needs CUDA tensors, got {q.device}")
    return flash_attention_op(q, k, v, scale, causal, window, softcap)
