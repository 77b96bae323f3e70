"""The arithmetic of flash_attention's bf16 tensor-core route, emulated on
the CPU in plain PyTorch and held against both packages' attention_ref.

The kernel (``csrc/flash_attention.cu``, ``flash_tc_kernel``) computes f32
logits from bf16 inputs (exact products, f32 sums), scales, soft-caps and
masks them, keeps an online max over key tiles of 64, and takes p and the
denominator l in f32. For P · V on the tensor cores it rounds P to bf16:
once (``split=False``), or split into p_hi = bf16(p) and
p_lo = bf16(p − p_hi), both products summed into one f32 accumulator
(``split=True``, what the kernel does). The output is rounded to bf16 once.

Tolerance: the port's bf16 pin, 2 bf16 ulps of each element, the ulp taken
at no less than 2^-8 of max |out| (``chip_smoke.py``'s TOL_ATTN_BF16_ULPS).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import TILES
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

TOL_ATTN_BF16_ULPS = 2.0


def emulate(q, k, v, *, scale, causal=True, window=None, softcap=None, split=True):
    """flash_tc_kernel's arithmetic, one key tile at a time. q: (B, Hq, S, D),
    k, v: (B, Hkv, S, D), all bf16; returns bf16 (B, Hq, S, D)."""
    bk = TILES["tensor_core"][1]
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    kf, vf = k.float(), v.float()
    m = torch.full((b, hkv, hq // hkv, s), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    qi = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        k1 = min(k0 + bk, s)
        kj = torch.arange(k0, k1)[None, :]
        x = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k1]) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        valid = torch.ones((s, k1 - k0), dtype=torch.bool)
        if causal:
            valid &= qi >= kj
        if window is not None:
            valid &= qi - kj < window
        x = torch.where(valid, x, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(x - m_new[..., None]), torch.tensor(0.0))
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        parts = (hi, (p - hi).to(torch.bfloat16).float()) if split else (hi,)
        o = o * alpha[..., None]
        for part in parts:
            o = o + torch.einsum("bhgqk,bhkd->bhgqd", part, vf[:, :, k0:k1])
        m = m_new
    out = o / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, s, d).to(torch.bfloat16)


def bf16_ulps(got, want):
    """max |got − want| in bf16 ulps of |want|, the ulp floored at 2^-8 of
    max |want|."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    mag = np.maximum(np.abs(want), np.max(np.abs(want)) / 256)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _inputs(seed, s, d, b=1, hq=4, hkv=2):
    """bf16 q, k, v from a numpy seed, as torch tensors and jax arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    return (tq, tk, tv), (jq, jk, jv)


def _as_f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("s", [200, 1024])
def test_split_p_holds_the_bf16_pin(s, d, softcap, window):
    (tq, tk, tv), (jq, jk, jv) = _inputs(s + d, s, d)
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap)
    got = emulate(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    for want in (attention_ref(tq, tk, tv, **kw), ref_attention_ref(jq, jk, jv, **kw)):
        assert bf16_ulps(_as_f32(got), _as_f32(want)) <= TOL_ATTN_BF16_ULPS


@pytest.mark.parametrize("window", [None, 300])
def test_single_bf16_p_misses_the_pin(window):
    """Why the kernel splits P: rounded once to bf16, P carries a 2^-9
    relative error into every output, far above the floored ulp; split, the
    same inputs stay within one ulp."""
    (tq, tk, tv), (jq, jk, jv) = _inputs(7, 1024, 256)
    kw = dict(scale=256 ** -0.5, window=window, softcap=50.0)
    want = _as_f32(ref_attention_ref(jq, jk, jv, **kw))
    single = bf16_ulps(_as_f32(emulate(tq, tk, tv, split=False, **kw)), want)
    split = bf16_ulps(_as_f32(emulate(tq, tk, tv, **kw)), want)
    assert single > 4 * TOL_ATTN_BF16_ULPS
    assert split <= 1.0
