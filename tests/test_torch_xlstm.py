"""repro_torch's xLSTM blocks (mLSTM, sLSTM) and the xlstm-125m trunk against
the reference on the CPU.

Smoke xlstm-125m (2 layers: mlstm, slstm; d_model 64, 4 heads) in f32, with
the reference's parameters through ``convert.params_from_jax``; inputs made
with numpy from a seed. Tolerance: 1e-5 of the largest magnitude of the
reference's result (the same f32 products and exponentials summed in
another order: einsum contractions, the chunk loop against ``lax.scan``).
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
from repro.models import transformer as RT
from repro.models import xlstm as ref_xl
from repro_torch.configs import base
from repro_torch.launch import probe, serve
from repro_torch.models import convert, xlstm
from repro_torch.models import model as M
from repro_torch.models import transformer as T

ARCH = "xlstm-125m"
TOL = 1e-5
BATCH, SEQ = 2, 24


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


def _cell(models, kind):
    """Layer 0 (mlstm) or layer 1 (slstm) of both packages."""
    cfg_ref, params_ref, cfg, model = models
    pos = {"mlstm": 0, "slstm": 1}[kind]
    p_ref = jax.tree.map(lambda t: t[0], params_ref["blocks"]["stack"][pos][kind])
    return cfg_ref, p_ref, cfg, getattr(model.blocks.layers[pos], kind)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tokens(cfg, seed, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _qkv_gates(seed, s, h=4, dh=32):
    """q, k, v (B, S, H, dh) and i_pre, f_pre (B, S, H) of the mLSTM scales:
    k scaled by dh^−½, input gates around 0, forget gates around 4."""
    q, k, v = (_normal(seed + j, (BATCH, s, h, dh)) for j in range(3))
    k = k * dh ** -0.5
    i_pre = _normal(seed + 3, (BATCH, s, h))
    f_pre = _normal(seed + 4, (BATCH, s, h)) + 4.0
    return q, k, v, i_pre, f_pre


# ------------------------------------------------------------------ configs --

@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_the_reference_field_for_field(smoke):
    got, want = base.get_config(ARCH, smoke=smoke), ref_base.get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_kinds == want.layer_kinds == ("mlstm", "slstm") * (got.num_layers // 2)
    assert got.param_count() == want.param_count()


def test_params_follow_the_reference_keys_and_init(models):
    cfg_ref, params_ref, cfg, model = models
    assert M.count_params(model) == RM.count_params(params_ref)
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.layers.0.mlstm.w_up", "blocks.layers.0.mlstm.skip_scale",
            "blocks.layers.1.slstm.r_z", "blocks.layers.1.slstm.w_ffgate",
            "embed.tokens"} <= names
    # self-contained blocks: no MLP, no pre_mlp_norm; tied embeddings
    assert not any(".mlp." in n or "pre_mlp_norm" in n for n in names)
    assert model.lm_head is None
    fresh = M.init_params(cfg, device="cpu")
    m, s = fresh.blocks.layers[0].mlstm, fresh.blocks.layers[1].slstm
    want = params_ref["blocks"]["stack"]
    for got, ref in ((m.b_f, want[0]["mlstm"]["b_f"][0]), (m.gn, want[0]["mlstm"]["gn"][0]),
                     (s.b_f, want[1]["slstm"]["b_f"][0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    assert not m.skip_scale.any() and not m.b_i.any() and not s.b_z.any()
    assert m.w_i.dtype == torch.float32 and s.r_i.shape == (4, 16, 16)
    assert s.w_up.shape == (64, 128)                  # (4·64/3 + 63) // 64 · 64
    # r_* drawn at fan-in H and halved: |r| ≤ 2 / √H / 2
    assert float(s.r_o.abs().max()) <= 0.5 + 1e-7


# ------------------------------------------------------------------- mLSTM --

@pytest.mark.parametrize("s", [24, 512])           # one chunk; two chunks of 256
def test_mlstm_chunkwise_matches_the_reference(models, s):
    cfg_ref = models[0]
    ins = _qkv_gates(10, s)
    got = xlstm._mlstm_chunkwise(*(torch.from_numpy(t) for t in ins))
    want = ref_xl._mlstm_chunkwise(*(jnp.asarray(t) for t in ins), cfg_ref)
    assert got.dtype == torch.float32
    _close(got, want)


def test_mlstm_chunks_equal_one_quadratic_chunk_on_a_shared_prefix():
    """S = 512 runs as two chunks of 256 with the state carried; S = 500 as
    one masked-quadratic chunk: the same function on the first 500."""
    ins = [torch.from_numpy(t) for t in _qkv_gates(20, 512)]
    chunked = xlstm._mlstm_chunkwise(*ins)
    quadratic = xlstm._mlstm_chunkwise(*(t[:, :500] for t in ins))
    _close(chunked[:, :500], quadratic.numpy())


def test_headwise_norm_matches_the_reference():
    x = _normal(30, (BATCH, 5, 4, 16), 3.0) + 1.0
    scale = _normal(31, (64,))
    _close(xlstm._headwise_norm(torch.from_numpy(scale), torch.from_numpy(x)),
           ref_xl._headwise_norm(jnp.asarray(scale), jnp.asarray(x)))


def _states(kind, cfg, seed):
    """A non-zero decode state of each package, from the same numbers."""
    b, d, h = BATCH, cfg.d_model, cfg.num_heads
    if kind == "mlstm":
        e = 2 * d
        dh = e // h
        st = {"C": _normal(seed, (b, h, dh, dh)), "n": _normal(seed + 1, (b, h, dh)),
              "m": _normal(seed + 2, (b, h)), "conv": _normal(seed + 3, (b, cfg.conv_width - 1, e))}
    else:
        st = {"h": _normal(seed, (b, d)), "c": _normal(seed + 1, (b, d)),
              "n": np.abs(_normal(seed + 2, (b, d))) + 0.5, "m": _normal(seed + 3, (b, d))}
    return ({k: torch.from_numpy(v.copy()) for k, v in st.items()},
            {k: jnp.asarray(v) for k, v in st.items()})


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_matches_the_reference_in_parallel_and_one_step(models, kind):
    cfg_ref, p_ref, cfg, p = _cell(models, kind)
    apply, apply_ref = ((xlstm.apply_mlstm, ref_xl.apply_mlstm) if kind == "mlstm"
                        else (xlstm.apply_slstm, ref_xl.apply_slstm))
    x = _normal(40, (BATCH, SEQ, cfg.d_model))
    got, state = apply(p, torch.from_numpy(x), cfg)
    want, state_ref = apply_ref(p_ref, jnp.asarray(x), cfg_ref)
    assert state is None and state_ref is None
    _close(got, want)
    # one step from a non-zero state: the output and every part of the state
    st, st_ref = _states(kind, cfg, 41)
    got, same = apply(p, torch.from_numpy(x[:, :1]), cfg, state=st)
    want, new_ref = apply_ref(p_ref, jnp.asarray(x[:, :1]), cfg_ref, state=st_ref)
    assert same is st                                # updated in place
    _close(got, want)
    assert set(st) == set(new_ref)
    for name in st:
        _close(st[name], new_ref[name])


def test_slstm_scan_is_the_repeated_step(models):
    cfg_ref, p_ref, cfg, p = _cell(models, "slstm")
    x = torch.from_numpy(_normal(50, (BATCH, 9, cfg.d_model)))
    full, _ = xlstm.apply_slstm(p, x, cfg)
    st = xlstm.init_slstm_state(cfg, BATCH, "cpu")
    steps = torch.cat([xlstm.apply_slstm(p, x[:, t:t + 1], cfg, state=st)[0] for t in range(9)],
                      dim=1)
    _close(steps, full.numpy())


# ------------------------------------------------------------------ trunks --

def test_forward_and_prefill_match_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 5)
    want, _, aux_ref = RM.forward(params_ref, jnp.asarray(toks), cfg_ref)
    got, _, aux = M.forward(model, torch.from_numpy(toks), cfg)
    _close(got, want)
    assert float(aux) == float(aux_ref) == 0.0
    last_ref, caches_ref = RM.prefill_step(params_ref, {"tokens": jnp.asarray(toks)}, cfg_ref)
    last, caches = M.prefill_step(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(last, last_ref)
    assert caches == [None, None] and caches_ref["stack"] == [None, None]


def test_layerwise_hidden_states_match_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 6, batch=5, seq=20)
    want = ref_layerwise_hidden_states(params_ref, jnp.asarray(toks), cfg_ref)
    got = probe.layerwise_hidden_states(model, torch.from_numpy(toks), cfg)
    assert got.shape == (1, 5, cfg.d_model)
    _close(got, want)


def test_decode_from_an_empty_state_matches_the_forward_and_the_reference(models):
    cfg_ref, params_ref, cfg, model = models
    toks = _tokens(cfg, 7)
    caches = T.init_trunk_cache(cfg, BATCH, SEQ, "cpu")
    assert set(caches[0]) == {"C", "n", "m", "conv"} and set(caches[1]) == {"h", "c", "n", "m"}
    assert float(caches[0]["m"].max()) == float(caches[1]["m"].max()) == float(np.float32(-1e30))
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
    for name in ("C", "n", "m", "conv"):
        _close(caches[0][name], np.asarray(caches_ref["stack"][0][name][0]))
    for name in ("h", "c", "n", "m"):
        _close(caches[1][name], np.asarray(caches_ref["stack"][1][name][0]))


# ------------------------------------------------------------------ launch --

def test_serve_refuses_a_model_without_prefill_state(models):
    _, _, cfg, model = models
    prompts = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="no recurrent state for its mlstm/slstm layers"):
        serve.generate(model, prompts, 4, cfg)
    with pytest.raises(ValueError, match="no recurrent state"):
        serve.main(["--smoke", "--device", "cpu", "--arch", ARCH, "--prompt-len", "8"])


def test_probe_cli_runs_the_xlstm(capsys):
    probe.main(["--smoke", "--device", "cpu", "--arch", ARCH, "--n-per-class", "12",
                "--seq-len", "8", "--n-perm", "20"])
    out = capsys.readouterr().out
    assert "layers(points)=1" in out and f"P={64}" in out
