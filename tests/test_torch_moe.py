"""repro_torch's MoE layer and MoE trunks against the reference on the CPU.

Smoke olmoe-1b-7b (MHA) and qwen3-moe-30b-a3b (GQA) in f32, with the
reference's parameters through ``convert.params_from_jax``; inputs made with
numpy from a seed. Tolerance: 1e-5 of the largest magnitude of the
reference's result (the same f32 arithmetic summed in another order).

The reference drops choices past an expert's capacity in the forward
(``int(S·k·cf/E) or 1`` slots per sequence) but never in decode (S = 1),
so decode equals forward only at the no-drop factor cf = E/k; both
packages differ there on purpose, and the tests hold each side to that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import model as RM
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro_torch.configs import base
from repro_torch.models import convert, moe
from repro_torch.models import model as M
from repro_torch.models import transformer as T

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
TOL = 1e-5
BATCH, SEQ = 2, 24


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)
    return err, scale


def _no_drop(cfg):
    return {"moe_capacity_factor": cfg.moe_experts / cfg.moe_top_k}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    cfg_ref = ref_base.get_config(arch, smoke=True)
    cfg = base.get_config(arch, smoke=True)
    params_ref = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    return cfg_ref, params_ref, cfg, model


def _tokens(cfg, seed, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _ref_drops(p, x, cfg):
    """The reference's routing, step by step: (expert index, dropped choices)."""
    b, s, _ = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = int(s * k * cfg.moe_capacity_factor / e) or 1
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32).reshape(b, s * k, e)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1.0) * onehot, axis=-1)
    return np.asarray(idx), int(jnp.sum(pos >= cap))


# ------------------------------------------------------------------ configs --

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch, smoke):
    got, want = base.get_config(arch, smoke=smoke), ref_base.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_params_follow_the_reference_keys(models):
    cfg_ref, params_ref, cfg, model = models
    assert M.count_params(model) == RM.count_params(params_ref)
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.layers.0.moe.router", "blocks.layers.1.moe.w_down", "lm_head"} <= names
    assert not any(".mlp." in n for n in names)
    blk = model.blocks.layers[1].moe
    assert blk.router.dtype == torch.float32 and blk.w_gate.shape == (
        cfg.moe_experts, cfg.d_model, cfg.d_ff) and blk.w_down.shape == (
        cfg.moe_experts, cfg.d_ff, cfg.d_model)
    fresh = M.init_params(cfg, device="cpu")
    assert M.count_params(fresh) == M.count_params(model)


# ---------------------------------------------------------------- apply_moe --

def _moe_case(models, seed, seq=SEQ, scale=3.0):
    cfg_ref, params_ref, cfg, model = models
    p_ref = jax.tree.map(lambda t: t[0], params_ref["blocks"]["stack"][0]["moe"])
    x = (scale * np.random.default_rng(seed).standard_normal(
        (BATCH, seq, cfg.d_model))).astype(np.float32)
    return cfg_ref, p_ref, cfg, model.blocks.layers[0].moe, x


def test_apply_moe_matches_the_reference_with_drops(models):
    cfg_ref, p_ref, cfg, p, x = _moe_case(models, 1)
    idx_ref, dropped = _ref_drops(p_ref, jnp.asarray(x), cfg_ref)
    assert dropped > 0                        # the reference drops choices here
    want, aux_ref = ref_moe.apply_moe(p_ref, jnp.asarray(x), cfg_ref)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, aux_ref)
    _, expert, slot, kept, _ = moe.route(p, torch.from_numpy(x), cfg)
    assert np.array_equal(expert.numpy(), idx_ref)
    assert int((~kept).sum()) == dropped
    # the kept slots: distinct per (group, expert), below capacity
    cap = moe.capacity(SEQ, cfg)
    for g in range(BATCH):
        pairs = {(int(e_), int(c_)) for e_, c_, k_ in zip(expert[g].flatten(),
                                                          slot[g].flatten(),
                                                          kept[g].flatten()) if k_}
        assert len(pairs) == int(kept[g].sum()) and max(c_ for _, c_ in pairs) < cap


def test_apply_moe_regroups_long_sequences(models, monkeypatch):
    cfg_ref, p_ref, cfg, p, x = _moe_case(models, 2, seq=64)
    monkeypatch.setattr(ref_moe, "MOE_GROUP", 16)
    monkeypatch.setattr(moe, "MOE_GROUP", 16)
    want, aux_ref = ref_moe.apply_moe(p_ref, jnp.asarray(x), cfg_ref)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _, scale = _close(got, want)
    _close(aux, aux_ref)
    _, dropped_16 = _ref_drops(p_ref, jnp.asarray(x.reshape(-1, 16, cfg.d_model)), cfg_ref)
    assert dropped_16 > 0
    # the grouping matters: capacity is per 16-token block, not per sequence
    monkeypatch.setattr(moe, "MOE_GROUP", 4096)
    whole, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    assert float((whole - got).abs().max()) > 1e-3 * scale


def test_apply_moe_without_drops_is_every_token_through_its_experts(models):
    cfg_ref, p_ref, cfg, p, x = _moe_case(models, 3)
    c = dataclasses.replace(cfg, **_no_drop(cfg))
    got, _ = moe.apply_moe(p, torch.from_numpy(x), c)
    xt = torch.from_numpy(x).double()
    gates, expert, _, kept, _ = moe.route(p, torch.from_numpy(x), c)
    assert bool(kept.all())
    want = torch.zeros_like(xt)
    wg, wu, wd = (w.double() for w in (p.w_gate, p.w_up, p.w_down))
    for b_ in range(BATCH):
        for s_ in range(SEQ):
            for j in range(cfg.moe_top_k):
                e_ = int(expert[b_, s_, j])
                h = torch.nn.functional.silu(xt[b_, s_] @ wg[e_]) * (xt[b_, s_] @ wu[e_])
                want[b_, s_] += gates[b_, s_, j].double() * (h @ wd[e_])
    _close(got, want.numpy())


# ------------------------------------------------------------------- trunks --

def test_forward_and_prefill_match_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 4)
    want, _, aux_ref = RM.forward(params_ref, jnp.asarray(toks), cfg_ref)
    got, caches, aux = M.forward(model, torch.from_numpy(toks), cfg)
    _close(got, want)
    _close(aux, aux_ref)
    assert caches is None and float(aux) > 0.0
    last_ref, caches_ref = RM.prefill_step(params_ref, {"tokens": jnp.asarray(toks)}, cfg_ref)
    last, caches = M.prefill_step(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(last, last_ref)
    assert len(caches) == cfg.num_layers
    for i, got_c in enumerate(caches):
        _close(got_c["k"], np.asarray(caches_ref["stack"][0]["k"][i]))


def _decode(cfg, model, toks):
    caches = T.init_trunk_cache(cfg, toks.shape[0], toks.shape[1], "cpu")
    return torch.stack([M.decode_step(model, torch.from_numpy(toks[:, t:t + 1]), t, caches,
                                      cfg)[0][:, 0] for t in range(toks.shape[1])], dim=1)


def _decode_ref(cfg_ref, params_ref, toks):
    caches = RT.init_trunk_cache(cfg_ref, toks.shape[0], toks.shape[1])
    step = jax.jit(lambda tok, pos, c: RM.decode_step(params_ref, tok, pos, c, cfg_ref))
    out = []
    for t in range(toks.shape[1]):
        logits, caches = step(jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32), caches)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1)


def test_decode_matches_the_reference_decode_at_the_default_factor(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 5)
    got = _decode(cfg, model, toks)
    _close(got, _decode_ref(cfg_ref, params_ref, toks))
    # at the default factor the forward drops choices and decode does not
    full, _, _ = M.forward(model, torch.from_numpy(toks), cfg)
    err = float((got - full).abs().max())
    assert err > 1e-2 * float(full.abs().max())


def test_decode_matches_the_forward_at_the_no_drop_factor(models):
    _, _, cfg, model = models
    c = dataclasses.replace(cfg, **_no_drop(cfg))
    toks = _tokens(cfg, 6)
    full, _, _ = M.forward(model, torch.from_numpy(toks), c)
    _close(_decode(c, model, toks), full.numpy())


def test_layerwise_hidden_states_match_the_reference(models):
    from repro.launch.probe import layerwise_hidden_states as ref_layerwise
    from repro_torch.launch import probe

    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 7, batch=5, seq=20)
    got = probe.layerwise_hidden_states(model, torch.from_numpy(toks), cfg)
    assert got.shape == (cfg.num_layers, 5, cfg.d_model)
    _close(got, ref_layerwise(params_ref, jnp.asarray(toks), cfg_ref))
