"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the reference's ``models/rglru.py``. Recurrence, per channel:

    r_t = σ(W_a x_t + b_a)                 recurrence gate (block-diagonal)
    i_t = σ(W_x x_t + b_x)                 input gate      (block-diagonal)
    a_t = exp(c · softplus(Λ) · (−r_t))    with c = 8, Λ learnable
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Over a whole sequence the linear recurrence runs as a doubling scan over
the sequence axis on f32 (a, b) pairs: ⌈log₂ S⌉ steps of whole-tensor ops,
each combining every position with the one 2^j before it (the reference
runs ``jax.lax.associative_scan``; no Pallas kernel). Decode carries
{"h": (B, R) f32, "conv": (B, W−1, R)} as O(1) state, updated in place.

Block (Griffin recurrent mixer): {linear → causal conv1d(W) → RG-LRU} ⊙
gelu(linear) → linear out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _pdt, dense_init_, param

_C = 8.0


class RGLRU(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, r, nb = cfg.d_model, cfg.rnn_width or cfg.d_model, cfg.num_heads
        rb, pdt, f32 = r // nb, _pdt(cfg), torch.float32
        self.w_x = param((d, r), pdt, device)
        self.w_gate = param((d, r), pdt, device)
        self.w_out = param((r, d), pdt, device)
        self.conv_w = param((cfg.conv_width, r), pdt, device)
        self.conv_b = param((r,), f32, device)
        self.w_a = param((nb, rb, rb), f32, device)
        self.w_input_gate = param((nb, rb, rb), f32, device)
        self.b_a = param((r,), f32, device)
        self.b_input_gate = param((r,), f32, device)
        self.a_param = param((r,), f32, device)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.w_x, self.w_gate, self.w_out, self.conv_w, self.w_a, self.w_input_gate):
            dense_init_(w, gen)
        for b in (self.conv_b, self.b_a, self.b_input_gate):
            b.zero_()
        # Λ so that a ≈ uniform(0.9, 0.999)^c at r = 0.5 (Griffin's appendix;
        # the reference's formula, deterministic)
        r = self.a_param.shape[0]
        lin = torch.linspace(0.9, 0.999, r, dtype=torch.float32, device=self.a_param.device)
        self.a_param.copy_(torch.log(torch.expm1(-torch.log(lin) / _C)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W. x: (B, S, R), w: (W, R).

    state: (B, W−1, R) trailing inputs of the previous segment (decode).
    Returns (y, new_state)."""
    width, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)                      # (B, S+W−1, R)
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    return y + b.to(y.dtype), xp[:, -(width - 1):]


def _block_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear in f32: x (..., R) with blocks w (NB, RB, RB)."""
    nb, rb, _ = w.shape
    xs = x.float().reshape(*x.shape[:-1], nb, rb)
    y = torch.einsum("...nr,nrq->...nq", xs, w).reshape(x.shape)
    return y + b


def _gates(p: RGLRU, x: torch.Tensor):
    """log a_t (f32, ≤ 0) and the gated input (f32); x: (B, S, R)."""
    r_t = torch.sigmoid(_block_linear(x, p.w_a, p.b_a))
    i_t = torch.sigmoid(_block_linear(x, p.w_input_gate, p.b_input_gate))
    log_a = -_C * F.softplus(p.a_param) * r_t
    a2 = torch.exp(2.0 * log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * i_t * x.float()
    return log_a, gated_x


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t along dim 1 from h_{−1} = 0, by doubling: after
    the step of span d each position holds the composition of the d steps
    ending there, (A, B) ∘ (A', B') = (A·A', A·B' + B)."""
    s = a.shape[1]
    for j in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << j
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b


def rglru_scan(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU. x: (B, S, R) -> (B, S, R) in x's dtype."""
    log_a, gx = _gates(p, x)
    return linear_scan(torch.exp(log_a), gx).to(x.dtype)


def rglru_step(p: RGLRU, x: torch.Tensor, h_prev: torch.Tensor):
    """One decode step. x: (B, 1, R), h_prev: (B, R) f32 -> (y (B, 1, R), h)."""
    log_a, gx = _gates(p, x)
    h = torch.exp(log_a[:, 0]) * h_prev + gx[:, 0]
    return h[:, None, :].to(x.dtype), h


def apply_recurrent_block(p: RGLRU, x: torch.Tensor, cfg: ArchConfig,
                          state: Optional[dict] = None):
    """Griffin recurrent mixer. x: (B, S, D).

    state: None (forward / prefill) or {"h": (B, R) f32, "conv": (B, W−1, R)},
    which one decode step updates IN PLACE. Returns (out, state)."""
    branch = x @ p.w_x.to(x.dtype)                                     # (B, S, R)
    gate = F.gelu(x @ p.w_gate.to(x.dtype), approximate="tanh")
    conv_w = p.conv_w.to(x.dtype)
    if state is None:
        h = rglru_scan(p, _causal_conv(branch, conv_w, p.conv_b)[0])
    else:
        conv_out, state["conv"] = _causal_conv(branch, conv_w, p.conv_b, state["conv"])
        h, state["h"] = rglru_step(p, conv_out, state["h"])
    return (h * gate) @ p.w_out.to(x.dtype), state


def init_recurrent_state(cfg: ArchConfig, batch: int, device) -> dict:
    r = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=_pdt(cfg), device=device)}
