"""Generic decoder trunk: pattern repeats, per-layer blocks, decode caches.

The port of the reference's ``models/transformer.py``. Architectures are
described by ``cfg.layer_pattern`` (gemma2 = ("local", "attn"),
recurrentgemma = ("rglru", "rglru", "local")); layers are grouped into
*repeats* of the pattern, and layers beyond the last full repeat form the
"tail". The reference stacks each pattern position's parameters over
repeats and runs one ``lax.scan``; here the trunk is an ``nn.ModuleList``
of blocks in layer order, run by a Python loop (layer ``r·len(pattern) +
i`` is repeat r, pattern position i), and :func:`_pattern_split` keeps
"repeat" meaning what it means there.

Block kinds: attn | local | cross | rglru | mlstm | slstm. Each is a
pre-norm residual mixer (self-attention, cross attention to the projected
vision tokens, the RG-LRU mixer, or an xLSTM cell). The attention-family
and rglru blocks are followed by a residual MLP, or an MoE when
``cfg.moe_experts`` (whose load-balancing loss the trunk sums); a cross
block scales both sub-blocks by tanh of its gates (zero at init, so a fresh
cross block is the identity). The xLSTM kinds are self-contained
(cfg.d_ff == 0). An unknown kind raises ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl

ATTN_KINDS = ("attn", "local", "cross")
XLSTM_KINDS = ("mlstm", "slstm")
KINDS = ATTN_KINDS + ("rglru",) + XLSTM_KINDS


# ----------------------------------------------------------------- blocks --

class Block(nn.Module):
    """One block: pre_norm → attn | cross | rglru | mlstm | slstm →
    [post_norm] → residual, then (not for the xLSTM kinds) pre_mlp_norm →
    mlp | moe → [post_mlp_norm] → residual. A cross block holds the scalar
    gates ``gate_attn`` and ``gate_mlp``."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.pre_norm = L.Norm(cfg, device=device)
        if kind in ATTN_KINDS:
            self.attn = L.Attention(cfg, device=device)
        elif kind == "rglru":
            self.rglru = rg.RGLRU(cfg, device=device)
        elif kind == "mlstm":
            self.mlstm = xl.MLSTM(cfg, device=device)
        else:
            self.slstm = xl.SLSTM(cfg, device=device)
        if kind == "cross":
            self.gate_attn = L.param((), torch.float32, device)
            self.gate_mlp = L.param((), torch.float32, device)
        self.post_norm = L.Norm(cfg, device=device) if cfg.post_norms else None
        if kind in XLSTM_KINDS:
            return
        self.pre_mlp_norm = L.Norm(cfg, device=device)
        if cfg.moe_experts:
            self.moe = moe_lib.MoE(cfg, device=device)
        else:
            self.mlp = L.MLP(cfg, device=device)
        self.post_mlp_norm = L.Norm(cfg, device=device) if cfg.post_norms else None

    def init_(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_(gen)
        if self.kind == "cross":
            self.gate_attn.zero_()
            self.gate_mlp.zero_()


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int, device) -> dict:
    """Static-shape decode cache for one block (zeros): K/V slots (a cross
    block's hold the ``vision_tokens`` K/V, never int8), or a recurrent
    block's state."""
    if kind == "rglru":
        return rg.init_recurrent_state(cfg, batch, device)
    if kind == "mlstm":
        return xl.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return xl.init_slstm_state(cfg, batch, device)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    cap = {"cross": cfg.vision_tokens,
           "local": min(cfg.local_window or cache_len, cache_len)}.get(kind, cache_len)
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant and kind != "cross":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=L._dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=L._dt(cfg), device=device)}


def _residual(x: torch.Tensor, out: torch.Tensor, norm: Optional[L.Norm],
              cfg: ArchConfig) -> torch.Tensor:
    if norm is not None:
        out = L.apply_norm(norm, out, cfg)
    if cfg.residual_scale is not None:
        # the scale rounded to the compute dtype first, as jax does with a
        # weakly typed Python float
        out = out * torch.tensor(cfg.residual_scale, dtype=out.dtype, device=out.device)
    return x + out


def _gated(p: Block, out: torch.Tensor, gate: str) -> torch.Tensor:
    """A cross block's sub-block output scaled by tanh of its gate (f32 tanh,
    cast); other blocks' as they are."""
    if p.kind != "cross":
        return out
    return out * torch.tanh(getattr(p, gate)).to(out.dtype)


def _mlp_residual(p: Block, x: torch.Tensor, cfg: ArchConfig):
    """The MLP (or MoE) sub-block: (x, the MoE's aux loss () f32, or None for
    a dense MLP). The xLSTM blocks have none: (x, None)."""
    if p.kind in XLSTM_KINDS:
        return x, None
    h2 = L.apply_norm(p.pre_mlp_norm, x, cfg)
    if cfg.moe_experts:
        out, aux = moe_lib.apply_moe(p.moe, h2, cfg)
    else:
        out, aux = L.apply_mlp(p.mlp, h2, cfg), None
    return _residual(x, _gated(p, out, "gate_mlp"), p.post_mlp_norm, cfg), aux


def _window(p: Block, cfg: ArchConfig) -> Optional[int]:
    return cfg.local_window if p.kind == "local" else None


def apply_block_full(p: Block, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
                     vis_kv: Optional[torch.Tensor] = None):
    """Train/prefill block. ``vis_kv``: the projected vision tokens (B, S_vis,
    D) a cross block attends to. Returns (x, cache_init, aux loss or None for
    a dense MLP): the cache is None for an ``rglru``, ``mlstm`` or ``slstm``
    block (prefill returns no recurrent state, as in the reference)."""
    h = L.apply_norm(p.pre_norm, x, cfg)
    if p.kind == "rglru":
        out, cache = rg.apply_recurrent_block(p.rglru, h, cfg)
    elif p.kind == "mlstm":
        out, cache = xl.apply_mlstm(p.mlstm, h, cfg)
    elif p.kind == "slstm":
        out, cache = xl.apply_slstm(p.slstm, h, cfg)
    elif p.kind == "cross":
        if vis_kv is None:
            raise ValueError(f"{cfg.name}: a cross layer needs vision_embeds")
        out, (k, v) = L.attention_full(p.attn, h, cfg, positions=positions, kv_src=vis_kv)
        out, cache = _gated(p, out, "gate_attn"), {"k": k, "v": v}
    else:
        out, (k, v) = L.attention_full(p.attn, h, cfg, positions=positions,
                                       window=_window(p, cfg))
        if cfg.kv_quant:
            kq, ks = L.quantize_kv(k)
            vq, vs = L.quantize_kv(v)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            cache = {"k": k, "v": v}
    x = _residual(x, out, p.post_norm, cfg)
    x, aux = _mlp_residual(p, x, cfg)
    return x, cache, aux


def apply_block_decode(p: Block, x: torch.Tensor, cfg: ArchConfig, *, pos: int, cache: dict):
    """Single-token decode block; updates ``cache`` (K/V slots or recurrent
    state) in place; a cross block reads its vision K/V and leaves them.
    Returns (x, cache)."""
    h = L.apply_norm(p.pre_norm, x, cfg)
    if p.kind == "rglru":
        out, cache = rg.apply_recurrent_block(p.rglru, h, cfg, state=cache)
    elif p.kind == "mlstm":
        out, cache = xl.apply_mlstm(p.mlstm, h, cfg, state=cache)
    elif p.kind == "slstm":
        out, cache = xl.apply_slstm(p.slstm, h, cfg, state=cache)
    elif p.kind == "cross":
        out = _gated(p, L.cross_attention_decode(p.attn, h, cfg, cross_k=cache["k"],
                                                 cross_v=cache["v"]), "gate_attn")
    else:
        out, cache = L.attention_decode(p.attn, h, cfg, cache=cache, pos=pos,
                                        window=_window(p, cfg))
    x = _residual(x, out, p.post_norm, cfg)
    return _mlp_residual(p, x, cfg)[0], cache


# ------------------------------------------------------------------ trunk --

def _pattern_split(cfg: ArchConfig):
    pat = cfg.layer_pattern
    n_rep = cfg.num_layers // len(pat)
    tail = cfg.layer_kinds[n_rep * len(pat):]
    return pat, n_rep, tail


def stacked_groups(names, cfg: ArchConfig) -> list:
    """``names`` (parameter names of a model of ``cfg``) grouped as the
    reference stores them: the blocks of one pattern position over the
    repeats are one array there (``blocks.stack``), so
    ``blocks.layers.<r·len(pattern) + i>.<key>`` for every repeat r is one
    group; a tail layer's and a top-level name are each their own."""
    pat, n_rep, _ = _pattern_split(cfg)
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        if parts[:2] == ["blocks", "layers"] and int(parts[2]) < n_rep * len(pat):
            key = (int(parts[2]) % len(pat), ".".join(parts[3:]))
        else:
            key = name
        groups.setdefault(key, []).append(name)
    return list(groups.values())


class Trunk(nn.Module):
    """The blocks in layer order (repeats of the pattern, then the tail)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, kind, device) for kind in cfg.layer_kinds)

    def init_(self, gen: torch.Generator) -> None:
        for blk in self.layers:
            blk.init_(gen)


def init_trunk_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> list:
    """One cache dict per layer, in layer order."""
    return [init_block_cache(cfg, kind, batch, cache_len, device) for kind in cfg.layer_kinds]


def _block_rematerialised(blk: Block, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                          vis_kv: Optional[torch.Tensor]):
    """(x, aux) of one block whose activations are recomputed in the backward
    instead of kept (no cache: a training forward collects none)."""
    def run(x_, vis_kv_):
        x_, _, a = apply_block_full(blk, x_, cfg, positions=positions, vis_kv=vis_kv_)
        return x_, a

    return checkpoint(run, x, vis_kv, use_reentrant=False)


def apply_trunk_full(trunk: Trunk, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
                     vis_kv: Optional[torch.Tensor] = None, collect_cache: bool = False):
    """Returns (x, per-layer caches or None, aux loss summed over the layers).

    With ``cfg.remat``, a graph being recorded (``x`` requires grad) and no
    caches to collect, each layer is rematerialised
    (``torch.utils.checkpoint``, non-reentrant): its forward runs again in
    the backward, as the reference's ``jax.checkpoint`` per repeat does, and
    only the layer inputs are kept. The numbers are those of the plain run.
    Serving (no graph) takes the plain loop."""
    remat = cfg.remat and torch.is_grad_enabled() and x.requires_grad and not collect_cache
    caches, aux = [], torch.zeros((), device=x.device)
    for blk in trunk.layers:
        if remat:
            x, a = _block_rematerialised(blk, x, cfg, positions, vis_kv)
            cache = None
        else:
            x, cache, a = apply_block_full(blk, x, cfg, positions=positions, vis_kv=vis_kv)
        if a is not None:
            aux = aux + a
        if collect_cache:
            caches.append(cache)
    return x, (caches if collect_cache else None), aux


def apply_trunk_decode(trunk: Trunk, x: torch.Tensor, cfg: ArchConfig, *, pos: int,
                       caches: list):
    """One decode step through every layer. The caches are updated IN PLACE
    (one slot per layer); the same list is returned."""
    for blk, cache in zip(trunk.layers, caches):
        x, _ = apply_block_decode(blk, x, cfg, pos=pos, cache=cache)
    return x, caches
