"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with memory
mixing), after Beck et al., arXiv:2405.04517.

The port of the reference's ``models/xlstm.py``. mLSTM runs chunkwise in
prefill and forward: the stabilised masked-quadratic form within a chunk
of ``MLSTM_CHUNK`` positions, the (C, n, m) state carried across chunks by
a Python loop; decode runs its recurrent form (state C (B, H, dh, dh), n
(B, H, dh), m (B, H) and the conv's trailing inputs). sLSTM is strictly
sequential (hidden-to-hidden memory mixing): a Python loop over the
sequence, one step per position, which makes its prefill host-bound on a
card; decode carries (h, c, n, m). Every state and gate is f32, as in the
reference, and the products they enter are f32 (full f32: nothing here
turns TF32 on).

Both use exponential gating with the paper's max-stabiliser state m. The
blocks are self-contained (cfg.d_ff == 0): the mLSTM block wraps its cell
in an up(2×)/down projection pair with a SiLU output gate; the sLSTM block
is followed by a gated 4/3-factor FFN. As in the reference, the q/k/v
projections are full (not block-diagonal) and the causal conv feeds q/k
only. No Pallas kernel: plain tensor math in both packages.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _pdt, dense_init_, param
from repro_torch.models.rglru import _causal_conv

_MIN_NORM = 1e-6
_M0 = -1e30                     # the stabiliser's start: exp(anything + _M0) is 0
MLSTM_CHUNK = 256


def _headwise_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head group norm (population variance) in f32. x: (B, S, H, dh);
    scale: (H·dh,). Returns (B, S, H·dh) in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out.flatten(-2) * scale).to(x.dtype)


# ================================================================== mLSTM ==

class MLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, h, pdt, f32 = cfg.d_model, cfg.num_heads, _pdt(cfg), torch.float32
        e = 2 * d                       # proj factor 2
        self.w_up = param((d, 2 * e), pdt, device)              # x_m | z
        self.conv_w = param((cfg.conv_width, e), pdt, device)
        self.conv_b = param((e,), f32, device)
        self.w_q = param((e, e), pdt, device)
        self.w_k = param((e, e), pdt, device)
        self.w_v = param((e, e), pdt, device)
        self.w_i = param((e, h), f32, device)
        self.w_f = param((e, h), f32, device)
        self.b_i = param((h,), f32, device)
        self.b_f = param((h,), f32, device)
        self.gn = param((e,), f32, device)
        self.skip_scale = param((e,), f32, device)
        self.w_down = param((e, d), pdt, device)

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.w_up, self.conv_w, self.w_q, self.w_k, self.w_v, self.w_i, self.w_f,
                  self.w_down):
            dense_init_(w, gen)
        for b in (self.conv_b, self.b_i, self.skip_scale):
            b.zero_()
        self.gn.fill_(1.0)
        # long-memory init, deterministic
        self.b_f.copy_(torch.linspace(3.0, 6.0, self.b_f.shape[0], dtype=torch.float32,
                                      device=self.b_f.device))


def _mlstm_qkv(p: MLSTM, x: torch.Tensor, cfg: ArchConfig,
               conv_state: Optional[torch.Tensor] = None):
    b, s, d = x.shape
    e, h = 2 * d, cfg.num_heads
    dh = e // h
    u = x @ p.w_up.to(x.dtype)
    x_m, z = u[..., :e], u[..., e:]
    c, new_conv = _causal_conv(x_m, p.conv_w.to(x.dtype), p.conv_b, conv_state)
    c = F.silu(c)
    q = (c @ p.w_q.to(x.dtype)).reshape(b, s, h, dh)
    # dh^−½ rounded to the compute dtype first, as jax does with a weakly
    # typed Python float
    k = (c @ p.w_k.to(x.dtype)).reshape(b, s, h, dh) * torch.tensor(dh ** -0.5, dtype=x.dtype,
                                                                    device=x.device)
    v = (x_m @ p.w_v.to(x.dtype)).reshape(b, s, h, dh)
    cf = c.float()
    i_pre = cf @ p.w_i + p.b_i                                  # (B, S, H) f32
    f_pre = cf @ p.w_f + p.b_f
    return q, k, v, i_pre, f_pre, c, z, new_conv


def _mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """Chunkwise-parallel mLSTM: O(S·L) memory instead of O(S²).

    Within a chunk of length L (``MLSTM_CHUNK`` when it divides S, else
    all of S) the stabilised masked-quadratic form; across chunks the
    (C, n, m) state, carried by a loop. Equal (up to float association) to
    the full quadratic form. q, k, v: (B, S, H, dh); i_pre, f_pre: (B, S, H)
    f32. Returns (B, S, H, dh) f32.
    """
    b, s, h, dh = q.shape
    chunk = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else s
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    log_f = F.logsigmoid(f_pre)
    c_prev = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
    n_prev = torch.zeros((b, h, dh), dtype=torch.float32, device=dev)
    m_prev = torch.full((b, h), _M0, dtype=torch.float32, device=dev)
    above = ~torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    outs = []
    for c0 in range(0, s, chunk):
        qc, kc, vc = (t[:, c0:c0 + chunk] for t in (qf, kf, vf))        # (B, L, H, dh)
        ic, fc = i_pre[:, c0:c0 + chunk], log_f[:, c0:c0 + chunk]      # (B, L, H)
        f_cum = fc.cumsum(dim=1)                                       # inclusive
        # intra-chunk log weights D_ij = F_i − F_j + i_j (j <= i), −inf above
        dmat = f_cum[:, :, None, :] - f_cum[:, None, :, :] + ic[:, None, :, :]
        dmat = dmat.masked_fill(above[None, :, :, None], float("-inf"))
        m_intra = dmat.amax(dim=2)                                     # (B, L, H)
        m_inter = f_cum + m_prev[:, None, :]                           # decay of the state
        m_i = torch.maximum(m_inter, m_intra)

        w_intra = torch.exp(dmat - m_i[:, :, None, :])
        scores = torch.einsum("bihd,bjhd->bijh", qc, kc) * w_intra
        num = torch.einsum("bijh,bjhd->bihd", scores, vc)
        den = scores.sum(dim=2)                                        # (B, L, H)

        w_inter = torch.exp(m_inter - m_i)
        num = num + w_inter[..., None] * torch.einsum("bhde,bihd->bihe", c_prev, qc)
        den = den + w_inter * torch.einsum("bhd,bihd->bih", n_prev, qc)
        denom = torch.maximum(den.abs(), torch.exp(-m_i))
        outs.append(num / (denom[..., None] + _MIN_NORM))

        # the end-of-chunk state
        f_tot = f_cum[:, -1, :]                                        # (B, H)
        tok = f_tot[:, None, :] - f_cum + ic                           # (B, L, H)
        m_new = torch.maximum(f_tot + m_prev, tok.amax(dim=1))
        w_old = torch.exp(f_tot + m_prev - m_new)
        w_tok = torch.exp(tok - m_new[:, None, :])
        c_prev = (w_old[:, :, None, None] * c_prev
                  + torch.einsum("bihd,bihe->bhde", w_tok[..., None] * kc, vc))
        n_prev = w_old[:, :, None] * n_prev + torch.einsum("bih,bihd->bhd", w_tok, kc)
        m_prev = m_new
    return torch.cat(outs, dim=1)


def apply_mlstm(p: MLSTM, x: torch.Tensor, cfg: ArchConfig, state: Optional[dict] = None):
    """x: (B, S, D). state: None (forward / prefill, chunkwise) or the decode
    state {"C", "n", "m", "conv"}, which one step updates IN PLACE. Returns
    (out (B, S, D), state)."""
    b, s, d = x.shape
    h = cfg.num_heads
    dh = 2 * d // h
    if state is None:
        q, k, v, i_pre, f_pre, c, z, _ = _mlstm_qkv(p, x, cfg)
        h_out = _mlstm_chunkwise(q, k, v, i_pre, f_pre).to(x.dtype)
    else:
        q, k, v, i_pre, f_pre, c, z, state["conv"] = _mlstm_qkv(p, x, cfg, state["conv"])
        log_f = F.logsigmoid(f_pre[:, 0])                              # (B, H)
        i_t = i_pre[:, 0]
        m_prev = state["m"]
        m_new = torch.maximum(log_f + m_prev, i_t)
        f_sc = torch.exp(log_f + m_prev - m_new)
        i_sc = torch.exp(i_t - m_new)
        k0, v0 = k[:, 0].float(), v[:, 0].float()
        kv = torch.einsum("bhd,bhe->bhde", k0, v0)
        c_new = f_sc[..., None, None] * state["C"] + i_sc[..., None, None] * kv
        n_new = f_sc[..., None] * state["n"] + i_sc[..., None] * k0
        qf = q[:, 0].float()
        num = torch.einsum("bhde,bhd->bhe", c_new, qf)
        denom = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, qf).abs(), torch.exp(-m_new))
        h_out = (num / (denom[..., None] + _MIN_NORM))[:, None].to(x.dtype)
        state["C"], state["n"], state["m"] = c_new, n_new, m_new

    h_n = _headwise_norm(p.gn, h_out.reshape(b, -1, h, dh))
    h_n = h_n + p.skip_scale.to(x.dtype) * c
    h_n = h_n * F.silu(z)
    return h_n @ p.w_down.to(x.dtype), state


def init_mlstm_state(cfg: ArchConfig, batch: int, device) -> dict:
    e, h = 2 * cfg.d_model, cfg.num_heads
    dh = e // h
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), _M0, dtype=f32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, e), dtype=_pdt(cfg), device=device)}


# ================================================================== sLSTM ==

GATES = ("i", "f", "z", "o")


class SLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, h, pdt, f32 = cfg.d_model, cfg.num_heads, _pdt(cfg), torch.float32
        dh = d // h
        ff = (4 * d // 3 + 63) // 64 * 64       # gated FFN, proj factor 4/3
        self.gn = param((d,), f32, device)
        self.w_up = param((d, ff), pdt, device)
        self.w_ffgate = param((d, ff), pdt, device)
        self.w_down = param((ff, d), pdt, device)
        for n in GATES:
            setattr(self, f"w_{n}", param((d, d), pdt, device))
        for n in GATES:
            setattr(self, f"r_{n}", param((h, dh, dh), f32, device))
        for n in GATES:
            setattr(self, f"b_{n}", param((d,), f32, device))

    def init_(self, gen: torch.Generator) -> None:
        self.gn.fill_(1.0)
        for w in (self.w_up, self.w_ffgate, self.w_down):
            dense_init_(w, gen)
        for n in GATES:
            dense_init_(getattr(self, f"w_{n}"), gen)
        for n in GATES:
            r = getattr(self, f"r_{n}")
            dense_init_(r, gen)
            r.mul_(0.5)
        for n in GATES:
            getattr(self, f"b_{n}").fill_(3.0 if n == "f" else 0.0)


def _slstm_cell(r_all: torch.Tensor, xi, xf, xz, xo, carry):
    """One step. r_all: (H, dh, 4·dh), the recurrent blocks of i, f, z, o side
    by side (one block-diagonal product per step); x*: (B, D) f32."""
    h_prev, c_prev, n_prev, m_prev = carry
    b, d = h_prev.shape
    nh, dh = r_all.shape[0], d // r_all.shape[0]
    rec = torch.einsum("bhd,hdq->bhq", h_prev.reshape(b, nh, dh), r_all).reshape(b, nh, 4, dh)
    ri, rf, rz, ro = (rec[:, :, g].reshape(b, d) for g in range(4))
    i_pre = xi + ri
    f_pre = xf + rf
    z = torch.tanh(xz + rz)
    o = torch.sigmoid(xo + ro)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m_prev, i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f + m_prev - m_new)
    c_new = f_sc * c_prev + i_sc * z
    n_new = torch.clamp(f_sc * n_prev + i_sc, min=_MIN_NORM)
    return o * (c_new / n_new), c_new, n_new, m_new


def _recurrent_blocks(p: SLSTM) -> torch.Tensor:
    return torch.cat([getattr(p, f"r_{n}") for n in GATES], dim=-1)


def slstm_scan(p: SLSTM, xi, xf, xz, xo) -> torch.Tensor:
    """The sequential scan from the zero state: x* (B, S, D) f32 -> h (B, S, D)
    f32, one step per position."""
    b, s, d = xi.shape
    dev = xi.device
    carry = tuple(torch.full((b, d), v, dtype=torch.float32, device=dev)
                  for v in (0.0, 0.0, 0.0, _M0))                      # h, c, n, m
    r_all = _recurrent_blocks(p)
    hs = []
    for t in range(s):
        carry = _slstm_cell(r_all, xi[:, t], xf[:, t], xz[:, t], xo[:, t], carry)
        hs.append(carry[0])
    return torch.stack(hs, dim=1)


def apply_slstm(p: SLSTM, x: torch.Tensor, cfg: ArchConfig, state: Optional[dict] = None):
    """x: (B, S, D). state: None (the sequential scan over S) or the decode
    state {"h", "c", "n", "m"}, which one step updates IN PLACE. Returns
    (out (B, S, D), state)."""
    b, s, d = x.shape
    nh = cfg.num_heads
    xf32 = x.float()
    pre = [xf32 @ getattr(p, f"w_{n}").float() + getattr(p, f"b_{n}") for n in GATES]
    if state is None:
        h_seq = slstm_scan(p, *pre)
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
        new = _slstm_cell(_recurrent_blocks(p), *(t[:, 0] for t in pre), carry)
        state["h"], state["c"], state["n"], state["m"] = new
        h_seq = new[0][:, None]

    h_n = _headwise_norm(p.gn, h_seq.reshape(b, -1, nh, d // nh)).to(x.dtype)
    # gated FFN (PF 4/3)
    up = h_n @ p.w_up.to(x.dtype)
    gate = F.gelu(h_n @ p.w_ffgate.to(x.dtype), approximate="tanh")
    return (up * gate) @ p.w_down.to(x.dtype), state


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> dict:
    d, f32 = cfg.d_model, torch.float32
    return {"h": torch.zeros((batch, d), dtype=f32, device=device),
            "c": torch.zeros((batch, d), dtype=f32, device=device),
            "n": torch.zeros((batch, d), dtype=f32, device=device),
            "m": torch.full((batch, d), _M0, dtype=f32, device=device)}
