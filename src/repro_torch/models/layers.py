"""Core transformer layers: norms, RoPE, GQA attention (+cache), MLPs.

The port of the reference's ``models/layers.py``. Parameters live in small
``nn.Module``s whose attribute names are the reference's parameter keys;
the ``apply`` functions take the module and stay functional, as the
reference's do. Attention weights are stored 3-D — wq (D, H, Dh),
wo (H, Dh, D) — as in the reference, and multiplied as 2-D views.

Compute dtype is bf16 with f32 norms/softmax/logits at the full configs;
the smoke configs run everything in f32. Of the reference's sharding
hints (``constrain``) the port keeps those a DTensor trace needs to
resolve a layout (``launch.dryrun``): each is a no-op outside
``launch.sharding.axis_ctx``.

On a CUDA tensor the self-attention of :func:`attention_full` is the
hand-written flash_attention kernel; on a CPU tensor its plain version.
The decode attention and the cross attention to vision tokens (prefill
and decode, :func:`cross_attention`) stay plain PyTorch, as they are plain
XLA in the reference: its Pallas kernel is self-attention only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.launch.sharding import constrain, mesh_active


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised parameter. The serving and probe paths run forward
    only, so no parameter records gradients."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dense_init_(w: torch.Tensor, gen: torch.Generator, in_axis: int = 0) -> None:
    """Truncated normal on [−2, 2] scaled by fan_in^−½, drawn in f32 and cast
    (the reference's ``dense_init``; other numbers from the same seed)."""
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(tmp * (1.0 / float(w.shape[in_axis]) ** 0.5))


# ------------------------------------------------------------------ norms --

class Norm(nn.Module):
    def __init__(self, cfg: ArchConfig, d: Optional[int] = None, device=None):
        super().__init__()
        d = d or cfg.d_model
        self.scale = param((d,), torch.float32, device)
        self.bias = param((d,), torch.float32, device) if cfg.norm == "layernorm" else None

    def init_(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()


def apply_norm(p: Norm, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p.scale + p.bias
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p.scale
    return out.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm (qk-norm, Qwen3-style); x: (..., Dh), f32 math."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (out * scale).to(x.dtype)


# ------------------------------------------------------------------- rope --

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) or (S,). Pairwise rotation."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * freqs[None, None, :]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]   # (B, S, 1, half)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) or (S,) -> (B, S, D) f32 sinusoidal embeddings (MusicGen-style):
    [sin | cos] of position · exp(−ln 10000 · i / (D/2))."""
    if positions.ndim == 1:
        positions = positions[None, :]
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------------------------- attention --

class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pdt = _pdt(cfg)
        self.wq = param((d, h, dh), pdt, device)
        self.wk = param((d, hkv, dh), pdt, device)
        self.wv = param((d, hkv, dh), pdt, device)
        self.wo = param((h, dh, d), pdt, device)
        self.q_norm = param((dh,), torch.float32, device) if cfg.qk_norm else None
        self.k_norm = param((dh,), torch.float32, device) if cfg.qk_norm else None

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)
        for s in (self.q_norm, self.k_norm):
            if s is not None:
                s.fill_(1.0)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) · (D, H, Dh) → (B, S, H, Dh), as one 2-D product."""
    d, h, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                 kv_src: Optional[torch.Tensor] = None):
    """q from x; k, v from ``kv_src`` (cross attention: the projected vision
    tokens, no RoPE) or from x."""
    src = x if kv_src is None else kv_src
    q, k, v = _project(x, p.wq), _project(src, p.wk), _project(src, p.wv)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_head_norm(p.k_norm, k, cfg.norm_eps)
    if kv_src is None and cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, p: Attention) -> torch.Tensor:
    """(B, S, H, Dh) · (H, Dh, D) → (B, S, D)."""
    h, dh, d = p.wo.shape
    return out.flatten(-2) @ p.wo.to(out.dtype).reshape(h * dh, d)


def _query_scale(cfg: ArchConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None else cfg.head_dim ** -0.5


def _graph_needed(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def scale_(t: torch.Tensor, c: float) -> torch.Tensor:
    """t · c, in place on a fresh ``t`` unless a gradient needs it (at a
    256,000 vocabulary each copy of the logits is GBs)."""
    return t * c if _graph_needed(t) else t.mul_(c)


def softcap_(t: torch.Tensor, c: float) -> torch.Tensor:
    """c · tanh(t / c): division, tanh and multiplication in this order, in
    place on a fresh ``t`` unless a gradient needs it (``mul_`` would
    overwrite the output that ``tanh_`` saved for its backward). Both
    forms give the same bits."""
    if _graph_needed(t):
        return torch.tanh(t / c) * c
    return t.div_(c).tanh_().mul_(c)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention of q (B, Sq, Hq, Dh) over every key of k, v
    (B, Skv, Hkv, Dh): f32 logits and softmax, query head h reading KV head
    h // group. Returns (B, Sq, Hq, Dh) in q's dtype. The cross layers'
    route in prefill and decode alike."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    logits = scale_(torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()), scale)
    if softcap is not None:
        logits = softcap_(logits, softcap)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def attention_full(p: Attention, x: torch.Tensor, cfg: ArchConfig, *, positions: torch.Tensor,
                   window: Optional[int] = None, causal: bool = True,
                   kv_src: Optional[torch.Tensor] = None):
    """Full-sequence attention (prefill / forward). Returns (out (B, S, D),
    (k, v)) with k, v in (B, S, Hkv, Dh) for the caches; with ``kv_src``
    (B, S_vis, D) cross attention to it (no RoPE, not causal, through
    :func:`cross_attention`), whose k, v (B, S_vis, Hkv, Dh) are the cross
    layer's cache.

    The Hkv heads go to the kernel as they are (query head h reads KV head
    h // group): the reference repeats K/V to Hq heads for its tensor-
    parallel sharding, which computes the same function, and the port does
    so only under a mesh (:func:`_on_own_heads`). q, k and v go in
    as (B, H, S, Dh) views of the projections, and the output comes back
    in (B, S, H, Dh) memory, so neither side is copied on the card.
    """
    q, k, v = _project_qkv(p, x, cfg, positions, kv_src)
    scale = _query_scale(cfg)

    def attend(q, k, v):                       # (B, S, H, Dh) in and out
        if kv_src is not None:
            return cross_attention(q, k, v, scale=scale, softcap=cfg.attn_logit_softcap)
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               scale=scale, causal=causal, window=window,
                               softcap=cfg.attn_logit_softcap).transpose(1, 2)

    out = _on_own_heads(attend, q, k, v) if mesh_active(q) else attend(q, k, v)
    return constrain(_out_proj(out, p), ("batch", "seq", "embed")), (k, v)


def _on_own_heads(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Under a mesh, the reference's layout of full attention: k and v
    (B, S, Hkv, Dh) repeated to the Hq query heads (head h reads KV head
    h // group, the same function), q, k and v split on "batch" and
    "heads" (where the heads divide the axis), and each rank attending
    over its own shards, as tensor-parallel attention does (DTensor has no
    strategy for the plain version's products over a batch split on two
    mesh axes). The sequence stays whole, so a query sees every key even
    under sequence parallelism. Returns ``attend``'s output in q's layout."""
    from torch.distributed.tensor import DTensor

    b, s, hkv, dh = k.shape
    group = q.shape[2] // hkv

    def repeat(t):
        return t[:, :, :, None].expand(b, s, hkv, group, dh).reshape(b, s, hkv * group, dh)

    spec = ("batch", None, "heads", None)
    q, k, v = (constrain(t, spec) for t in (q, repeat(k), repeat(v)))
    out = attend(q.to_local(), k.to_local(), v.to_local())
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


def quantize_kv(t: torch.Tensor):
    """Per-(token, head) int8 KV quantisation. t: (B, S, H, Dh) ->
    (int8 values, f32 scales (B, S, H))."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def attention_decode(p: Attention, x: torch.Tensor, cfg: ArchConfig, *, cache: dict, pos: int,
                     window: Optional[int] = None):
    """Single-token decode against a static-shape KV cache.

    x: (B, 1, D). cache: {"k", "v"} of (B, C, Hkv, Dh), C the capacity (the
    full context, or the ring buffer of a local layer's window); int8 with
    per-(slot, head) f32 scales "k_scale"/"v_scale" (B, C, Hkv) when
    cfg.kv_quant. pos: absolute position of the new token.

    The new token's K/V are written into ``cache`` IN PLACE (the reference
    returns updated copies); returns (out (B, 1, D), cache).
    """
    b = x.shape[0]
    cap = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    slot = pos % cap if window is not None else min(pos, cap - 1)
    if "k_scale" in cache:
        k_q, k_s = quantize_kv(k_new)
        v_q, v_s = quantize_kv(v_new)
        cache["k"][:, slot] = k_q[:, 0]
        cache["v"][:, slot] = v_q[:, 0]
        cache["k_scale"][:, slot] = k_s[:, 0]
        cache["v_scale"][:, slot] = v_s[:, 0]
        k_eff = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_eff = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        k_eff, v_eff = cache["k"], cache["v"]

    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = _decode_query(q).reshape(b, 1, hkv, hq // hkv, dh)
    logits = torch.einsum("bqhgk,bchk->bhgqc", qg.float(), k_eff.float()) * _query_scale(cfg)
    if cfg.attn_logit_softcap is not None:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    idx = torch.arange(cap, device=x.device)
    if window is not None:
        # ring buffer: slot c holds absolute position pos - ((slot - c) % cap)
        age = (slot - idx) % cap
        valid = (pos - age >= 0) & (age < cap)
    else:
        valid = idx <= pos
    logits = torch.where(valid, logits, torch.tensor(NEG_INF, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqc,bchk->bqhgk", probs, v_eff.float())
    out = out.reshape(b, 1, hq, dh).to(x.dtype)
    return _out_proj(out, p), cache


def cross_attention_decode(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                           cross_k: torch.Tensor, cross_v: torch.Tensor) -> torch.Tensor:
    """Decode-time cross attention of x (B, 1, D) against the cached vision
    K/V (B, S_vis, Hkv, Dh), which stay as they are. No soft-cap, as in the
    reference's decode."""
    q = _project(x, p.wq)
    if cfg.qk_norm:
        q = rms_head_norm(p.q_norm, q, cfg.norm_eps)
    return _out_proj(cross_attention(_decode_query(q), cross_k, cross_v,
                                     scale=_query_scale(cfg)), p)


def _decode_query(q: torch.Tensor) -> torch.Tensor:
    """Under a mesh a decode query (B, 1, Hq, Dh) keeps every head whole on
    each rank: the grouped read by KV head cannot split a group over ranks,
    and the cache's own layout splits the work (the dry run puts "model" on
    a cache's largest dim, the slots of a self-attention cache, so a rank
    attends with every head over its own slots)."""
    return constrain(q, ("batch", "seq", "kv_heads", None))


# ------------------------------------------------------------------- mlps --

class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f, pdt = cfg.d_model, cfg.d_ff, _pdt(cfg)
        self.w_up = param((d, f), pdt, device)
        self.w_down = param((f, d), pdt, device)
        self.w_gate = param((d, f), pdt, device) if cfg.mlp in ("swiglu", "geglu") else None

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.w_up, self.w_down, self.w_gate):
            if w is not None:
                dense_init_(w, gen)


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    up = constrain(x @ p.w_up.to(x.dtype), ("batch", "seq", "ffn"))
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p.w_gate.to(x.dtype)) * up
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p.w_gate.to(x.dtype), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return constrain(h @ p.w_down.to(x.dtype), ("batch", "seq", "embed"))
