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

Block kinds here: attn | local | rglru. Each is a pre-norm residual mixer
(attention, or the RG-LRU recurrent mixer) followed by a residual MLP, or
an MoE when ``cfg.moe_experts`` (whose load-balancing loss the trunk
sums). The other kinds (cross, mlstm, slstm) wait for their modules
(ROADMAP A14).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rg

ATTN_KINDS = ("attn", "local")
KINDS = ATTN_KINDS + ("rglru",)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    kinds = sorted(set(cfg.layer_kinds) - set(KINDS))
    missing = ([f"block kinds {kinds}"] if kinds else []) + [
        what for what, on in (("audio codebooks", cfg.num_codebooks),
                              ("vision cross-attention", cfg.vision_tokens),
                              (f"{cfg.pos_embedding} positions", cfg.pos_embedding == "sinusoidal"))
        if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} are not ported yet "
                                  "(ROADMAP A14)")


# ----------------------------------------------------------------- blocks --

class Block(nn.Module):
    """One block: pre_norm → attn | rglru → [post_norm] → residual, then
    pre_mlp_norm → mlp | moe → [post_mlp_norm] → residual."""

    def __init__(self, cfg: ArchConfig, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.pre_norm = L.Norm(cfg, device=device)
        if kind == "rglru":
            self.rglru = rg.RGLRU(cfg, device=device)
        else:
            self.attn = L.Attention(cfg, device=device)
        self.post_norm = L.Norm(cfg, device=device) if cfg.post_norms else None
        self.pre_mlp_norm = L.Norm(cfg, device=device)
        if cfg.moe_experts:
            self.moe = moe_lib.MoE(cfg, device=device)
        else:
            self.mlp = L.MLP(cfg, device=device)
        self.post_mlp_norm = L.Norm(cfg, device=device) if cfg.post_norms else None

    def init_(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_(gen)


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int, device) -> dict:
    """Static-shape decode cache for one block (zeros): K/V slots, or an
    ``rglru`` block's recurrent state."""
    if kind == "rglru":
        return rg.init_recurrent_state(cfg, batch, device)
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (ROADMAP A14)")
    cap = min(cfg.local_window or cache_len, cache_len) if kind == "local" else cache_len
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
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


def _mlp_residual(p: Block, x: torch.Tensor, cfg: ArchConfig):
    """The MLP (or MoE) sub-block: (x, the MoE's aux loss () f32, or None for
    a dense MLP)."""
    h2 = L.apply_norm(p.pre_mlp_norm, x, cfg)
    if cfg.moe_experts:
        out, aux = moe_lib.apply_moe(p.moe, h2, cfg)
    else:
        out, aux = L.apply_mlp(p.mlp, h2, cfg), None
    return _residual(x, out, p.post_mlp_norm, cfg), aux


def _window(p: Block, cfg: ArchConfig) -> Optional[int]:
    return cfg.local_window if p.kind == "local" else None


def apply_block_full(p: Block, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor):
    """Train/prefill block. Returns (x, cache_init, aux loss or None for a
    dense MLP): the cache is None for an ``rglru`` block (prefill returns no
    recurrent state, as in the reference)."""
    h = L.apply_norm(p.pre_norm, x, cfg)
    if p.kind == "rglru":
        out, cache = rg.apply_recurrent_block(p.rglru, h, cfg)
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
    state) in place. Returns (x, cache)."""
    h = L.apply_norm(p.pre_norm, x, cfg)
    if p.kind == "rglru":
        out, cache = rg.apply_recurrent_block(p.rglru, h, cfg, state=cache)
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


class Trunk(nn.Module):
    """The blocks in layer order (repeats of the pattern, then the tail)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.layers = nn.ModuleList(Block(cfg, kind, device) for kind in cfg.layer_kinds)

    def init_(self, gen: torch.Generator) -> None:
        for blk in self.layers:
            blk.init_(gen)


def init_trunk_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> list:
    """One cache dict per layer, in layer order."""
    return [init_block_cache(cfg, kind, batch, cache_len, device) for kind in cfg.layer_kinds]


def apply_trunk_full(trunk: Trunk, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
                     collect_cache: bool = False):
    """Returns (x, per-layer caches or None, aux loss summed over the layers)."""
    caches, aux = [], torch.zeros((), device=x.device)
    for blk in trunk.layers:
        x, cache, a = apply_block_full(blk, x, cfg, positions=positions)
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
