"""Mixture-of-Experts layer: top-k routing, capacity dispatch, experts.

The port of the reference's ``models/moe.py``. Routing follows OLMoE /
Qwen3-MoE: f32 router logits, softmax over experts, top-k, gate values
renormalised over the k chosen. Tokens are grouped per sequence (and long
sequences into blocks of :data:`MOE_GROUP` tokens); each group has
``int(S·k·cf/E) or 1`` capacity slots per expert, filled in the group's
flattened (S·k) order, token-major and choice-minor. Choices past an
expert's capacity are dropped and the residual passes through. An
auxiliary load-balancing loss (Switch Transformer form) is returned.

The reference dispatches and combines with one-hot einsums, a TPU device
for static shapes. Here the dispatch is an index write: each kept choice
copies its token into its (expert, slot) row of one buffer, the experts run
as batched products over E, and the combine gathers each token's k expert
rows and sums them with their gates in one batched product. Empty slots
compute zeros that nothing reads. The kept slots and the outputs are the
reference's; no step syncs with the host.

``torch.topk`` promises no order among exactly equal probabilities, where
``jax.lax.top_k`` takes the lower expert index first. Exact ties do not
occur with random weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _pdt, dense_init_, param

#: Sequences longer than this (and a multiple of it) dispatch in blocks of
#: this many tokens: capacity is per block.
MOE_GROUP = 4096


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f, e, pdt = cfg.d_model, cfg.d_ff, cfg.moe_experts, _pdt(cfg)
        self.router = param((d, e), torch.float32, device)
        self.w_gate = param((e, d, f), pdt, device)
        self.w_up = param((e, d, f), pdt, device)
        self.w_down = param((e, f, d), pdt, device)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.router, self.w_gate, self.w_up):
            dense_init_(w, gen)
        dense_init_(self.w_down, gen, in_axis=1)


def capacity(s: int, cfg: ArchConfig) -> int:
    """Slots per expert in a group of ``s`` tokens."""
    return int(s * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_experts) or 1


def route(p: MoE, x: torch.Tensor, cfg: ArchConfig):
    """Routing of one (G, S, D) batch of groups.

    Returns (gates (G, S, k) f32, expert (G, S, k) int64, slot (G, S, k)
    int64 — each choice's position in its expert's queue, kept (G, S, k)
    bool — slot < capacity, aux loss () f32).
    """
    g, s, _ = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(x.float() @ p.router, dim=-1)               # (G, S, E)
    gates, expert = torch.topk(probs, k, dim=-1)                       # (G, S, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-style load-balancing loss: mean router prob × share of first choices
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert[..., 0], e).sum(dim=(0, 1)).float() / (g * s)
    aux = e * torch.sum(me * ce) * cfg.moe_aux_loss_coef
    # a choice's slot: the choices to its expert before it in the group's
    # flattened (S·k) order
    flat = expert.reshape(g, s * k)
    before = F.one_hot(flat, e).cumsum(dim=1, dtype=torch.int32)       # (G, S·k, E)
    slot = (before.gather(-1, flat[..., None])[..., 0] - 1).long().reshape(g, s, k)
    return gates, expert, slot, slot < capacity(s, cfg), aux


def apply_moe(p: MoE, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, D) -> (out (B, S, D), aux_loss () f32)."""
    b, s, d = x.shape
    if s > MOE_GROUP and s % MOE_GROUP == 0:
        out, aux = apply_moe(p, x.reshape(b * (s // MOE_GROUP), MOE_GROUP, d), cfg)
        return out.reshape(b, s, d), aux
    e, k, cap = cfg.moe_experts, cfg.moe_top_k, capacity(s, cfg)
    gates, expert, slot, kept, aux = route(p, x, cfg)

    # dispatch: row e·(B·C) + b·C + slot of one buffer holds the token of that
    # slot; dropped choices all write the spare last row, which nothing reads
    group = torch.arange(b, device=x.device)[:, None, None]
    rows = torch.where(kept, expert * (b * cap) + group * cap + slot, e * b * cap)
    buf = x.new_zeros((e * b * cap + 1, d))
    buf[rows.flatten()] = x[:, :, None, :].expand(b, s, k, d).reshape(b * s * k, d)
    xe = buf[:-1].view(e, b * cap, d)

    h = F.silu(torch.bmm(xe, p.w_gate.to(x.dtype))) * torch.bmm(xe, p.w_up.to(x.dtype))
    y = torch.bmm(h, p.w_down.to(x.dtype)).view(e * b * cap, d)

    # combine: each token's k expert rows weighted by their gates (0 if dropped)
    w = torch.where(kept, gates, 0.0).to(x.dtype).reshape(b * s, 1, k)
    picked = y[torch.where(kept, rows, 0).flatten()].view(b * s, k, d)
    return torch.bmm(w, picked).view(b, s, d), aux
