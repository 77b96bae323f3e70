"""Int8 error-feedback gradient compression.

The port of the reference's ``optim/compression.py``. Quantising gradients
to int8 with a per-tensor scale cuts a data-parallel all-reduce's bytes 4x
(against f32); the quantisation error is fed back into the next step's
gradient (error feedback), so convergence is preserved. Here the transform
is applied before the optimizer consumes the gradients, as in the
reference; the numerics (quantise, dequantise, error feedback) are the
same, bit for bit: ``torch.round`` rounds half to even as ``jnp.round``
does.

The reference quantises each array of its parameter tree with one scale,
and it stacks a pattern position's block parameters over the repeats in
one array. The port keeps one tensor per layer, so the tensors that share
a scale are passed together as a group (``groups``, from
``models.transformer.stacked_groups``): the scale is the max over the
group, as over the reference's stacked array.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8", "quantize_int8_group", "dequantize_int8", "compress_decompress",
           "compress_group"]


def quantize_int8_group(xs: list):
    """([int8 codes per tensor], f32 scale ()): one scale for all of ``xs``,
    max |x| over them / 127 + 1e-30."""
    peak = xs[0].abs().max()
    for x in xs[1:]:
        peak = torch.maximum(peak, x.abs().max())
    scale = peak / 127.0 + 1e-30
    return [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8) for x in xs], scale


def quantize_int8(x: torch.Tensor):
    """(int8 codes, f32 scale ()): scale = max |x| / 127 + 1e-30."""
    (q,), scale = quantize_int8_group([x])
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_group(gs: list, es: list):
    """The int8 round trip with error feedback of tensors sharing one scale:
    ([int8 codes of g + e], f32 scale (), [new error g + e − dequantised])."""
    fbs = [g + e for g, e in zip(gs, es)]
    codes, scale = quantize_int8_group(fbs)
    return codes, scale, [fb - dequantize_int8(q, scale) for fb, q in zip(fbs, codes)]


def compress_decompress(grads: dict, err: dict, groups=None):
    """Int8 round trip with error feedback, one scale per group of names
    (``groups``, a list of lists; None: each tensor alone).

    grads, err: f32 tensors under the same names. Returns (decompressed
    grads, new err), dicts under those names.
    """
    deq, new_err = {}, {}
    for names in ([[n] for n in grads] if groups is None else groups):
        codes, scale, es = compress_group([grads[n] for n in names], [err[n] for n in names])
        deq.update((n, dequantize_int8(q, scale)) for n, q in zip(names, codes))
        new_err.update(zip(names, es))
    return {n: deq[n] for n in grads}, {n: new_err[n] for n in grads}
