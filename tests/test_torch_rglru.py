"""repro_torch's RG-LRU blocks and the recurrentgemma hybrid trunk against the
reference on the CPU.

Smoke recurrentgemma-2b (5 layers: rglru, rglru, local, rglru, rglru) in f32,
with the reference's parameters through ``convert.params_from_jax``; inputs
made with numpy from a seed. Tolerance: 1e-5 of the largest magnitude of the
reference's result. The port's doubling scan and the reference's
``associative_scan`` combine the same f32 pairs in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch.probe import layerwise_hidden_states as ref_layerwise_hidden_states
from repro.models import model as RM
from repro.models import rglru as ref_rg
from repro.models import transformer as RT
from repro_torch.configs import base
from repro_torch.launch import probe, serve
from repro_torch.models import convert, rglru
from repro_torch.models import model as M
from repro_torch.models import transformer as T

ARCH = "recurrentgemma-2b"
TOL = 1e-5
BATCH, SEQ = 2, 24            # SEQ > the smoke window of 16: the local layer's ring wraps


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def models():
    cfg_ref = ref_base.get_config(ARCH, smoke=True)
    cfg = base.get_config(ARCH, smoke=True)
    params_ref = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    return cfg_ref, params_ref, cfg, model


def _block(models):
    """Layer 0 (rglru) of both packages."""
    cfg_ref, params_ref, cfg, model = models
    p_ref = jax.tree.map(lambda t: t[0], params_ref["blocks"]["stack"][0]["rglru"])
    return cfg_ref, p_ref, cfg, model.blocks.layers[0].rglru


def _x(cfg, seed, seq=SEQ, width=None):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, seq, width or cfg.rnn_width)).astype(np.float32)


def _tokens(cfg, seed, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


# ------------------------------------------------------------------ configs --

@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_the_reference_field_for_field(smoke):
    got, want = base.get_config(ARCH, smoke=smoke), ref_base.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_kinds == want.layer_kinds


def test_params_follow_the_reference_keys_and_init(models):
    cfg_ref, params_ref, cfg, model = models
    assert M.count_params(model) == RM.count_params(params_ref)
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.layers.0.rglru.a_param", "blocks.layers.4.rglru.w_input_gate",
            "blocks.layers.2.attn.wq"} <= names
    assert not any(n.startswith("blocks.layers.0.attn") for n in names)
    fresh = M.init_params(cfg, device="cpu")
    want_a = np.asarray(params_ref["blocks"]["stack"][0]["rglru"]["a_param"][0])
    np.testing.assert_allclose(fresh.blocks.layers[0].rglru.a_param.numpy(), want_a,
                               rtol=1e-5, atol=0)   # f32 rounding of linspace/log
    assert not fresh.blocks.layers[1].rglru.b_a.any()


# --------------------------------------------------------------------- scan --

def test_rglru_scan_matches_the_reference_and_repeated_steps(models):
    cfg_ref, p_ref, cfg, p = _block(models)
    x = _x(cfg, 1)
    got = rglru.rglru_scan(p, torch.from_numpy(x))
    _close(got, ref_rg.rglru_scan(p_ref, jnp.asarray(x)))
    h = torch.zeros(BATCH, cfg.rnn_width)
    steps = []
    for t in range(SEQ):
        y, h = rglru.rglru_step(p, torch.from_numpy(x[:, t:t + 1]), h)
        steps.append(y)
    _close(got, torch.cat(steps, dim=1).numpy())
    y_ref, h_ref = ref_rg.rglru_step(p_ref, jnp.asarray(x[:, :1]), jnp.zeros((BATCH, 64)))
    _close(rglru.rglru_step(p, torch.from_numpy(x[:, :1]), torch.zeros(BATCH, 64))[1], h_ref)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 33])
def test_linear_scan_is_the_recurrence(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3)))
    b = torch.from_numpy(rng.standard_normal((2, s, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, dim=1).numpy(), 1e-12)


def test_causal_conv_with_and_without_state(models):
    cfg_ref, p_ref, cfg, p = _block(models)
    x = _x(cfg, 2)
    w, b = p.conv_w, p.conv_b
    y, st = rglru._causal_conv(torch.from_numpy(x), w, b)
    y_ref, st_ref = ref_rg._causal_conv(jnp.asarray(x), p_ref["conv_w"], p_ref["conv_b"])
    _close(y, y_ref)
    _close(st, st_ref)
    state = _x(cfg, 3, seq=cfg.conv_width - 1)
    y, st = rglru._causal_conv(torch.from_numpy(x[:, :5]), w, b, torch.from_numpy(state))
    y_ref, st_ref = ref_rg._causal_conv(jnp.asarray(x[:, :5]), p_ref["conv_w"],
                                        p_ref["conv_b"], jnp.asarray(state))
    _close(y, y_ref)
    _close(st, st_ref)
    # one segment equals two with the state carried between them
    y1, s1 = rglru._causal_conv(torch.from_numpy(x[:, :10]), w, b)
    y2, _ = rglru._causal_conv(torch.from_numpy(x[:, 10:]), w, b, s1)
    _close(torch.cat([y1, y2], dim=1), rglru._causal_conv(torch.from_numpy(x), w, b)[0].numpy())


def test_recurrent_block_matches_the_reference(models):
    cfg_ref, p_ref, cfg, p = _block(models)
    x = _x(cfg, 4, width=cfg.d_model)
    got, state = rglru.apply_recurrent_block(p, torch.from_numpy(x), cfg)
    want, _ = ref_rg.apply_recurrent_block({"rglru": p_ref}, jnp.asarray(x), cfg_ref)
    _close(got, want)
    assert state is None


# ------------------------------------------------------------------- trunks --

def test_forward_and_prefill_match_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 5)
    want, _, aux_ref = RM.forward(params_ref, jnp.asarray(toks), cfg_ref)
    got, _, aux = M.forward(model, torch.from_numpy(toks), cfg)
    _close(got, want)
    assert float(aux) == float(aux_ref) == 0.0
    last_ref, _ = RM.prefill_step(params_ref, {"tokens": jnp.asarray(toks)}, cfg_ref)
    last, caches = M.prefill_step(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(last, last_ref)
    assert [c is None for c in caches] == [k == "rglru" for k in cfg.layer_kinds]


def test_layerwise_hidden_states_match_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 6, batch=5, seq=20)
    want = ref_layerwise_hidden_states(params_ref, jnp.asarray(toks), cfg_ref)
    got = probe.layerwise_hidden_states(model, torch.from_numpy(toks), cfg)
    assert got.shape == (cfg.num_layers // 3, 5, cfg.d_model)
    _close(got, want)


def test_decode_from_an_empty_state_matches_the_forward_and_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 7)
    caches = T.init_trunk_cache(cfg, BATCH, SEQ, "cpu")
    assert set(caches[0]) == {"h", "conv"} and caches[0]["h"].dtype == torch.float32
    got = torch.stack([M.decode_step(model, torch.from_numpy(toks[:, t:t + 1]), t, caches,
                                     cfg)[0][:, 0] for t in range(SEQ)], dim=1)
    full, _, _ = M.forward(model, torch.from_numpy(toks), cfg)
    _close(got, full.numpy())

    caches_ref = RT.init_trunk_cache(cfg_ref, BATCH, SEQ)
    step = jax.jit(lambda tok, pos, c: RM.decode_step(params_ref, tok, pos, c, cfg_ref))
    want = []
    for t in range(SEQ):
        logits, caches_ref = step(jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32),
                                  caches_ref)
        want.append(np.asarray(logits[:, 0]))
    _close(got, np.stack(want, axis=1))
    # the recurrent state after the last step: layer 0 is stack position 0, repeat 0
    _close(caches[0]["h"], np.asarray(caches_ref["stack"][0]["h"][0]))
    _close(caches[4]["conv"], np.asarray(caches_ref["tail"][1]["conv"]))


# ------------------------------------------------------------------- launch --

def test_serve_refuses_a_model_without_prefill_state(models):
    _, _, cfg, model = models
    prompts = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="no recurrent state"):
        serve.generate(model, prompts, 4, cfg)
    with pytest.raises(ValueError, match="no recurrent state"):
        serve.main(["--smoke", "--device", "cpu", "--arch", ARCH, "--prompt-len", "8"])


def test_probe_cli_runs_the_hybrid(capsys):
    probe.main(["--smoke", "--device", "cpu", "--arch", ARCH, "--n-per-class", "12",
                "--seq-len", "8", "--n-perm", "20"])
    out = capsys.readouterr().out
    assert "layers(points)=1" in out
