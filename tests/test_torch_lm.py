"""repro_torch's LLM substrate against the reference on the CPU: configs,
the four dense smoke models (forward, prefill, decode, kv_quant decode),
the serving launcher, the layer-probe features and the probe itself.

The reference's parameters go through ``convert.params_from_jax``; token
inputs are made with numpy from a seed and handed to both packages.

Tolerances, relative to the largest magnitude of the reference's result:
* logits and caches of the f32 smoke models ≤ 1e-4: a few layers of f32
  products and softmaxes summed in another order (einsum vs 2-D matmul,
  dense XLA softmax vs PyTorch's) differ by ~1e-6 relative per layer;
* the int8 kv_quant decode ≤ 2e-2: when the K/V of the two packages differ
  by ~1e-6, an element that sits on a rounding boundary of its int8 code
  moves by one step (1/127 of its head's max), and that step reaches the
  logits;
* the probe's observed accuracies, nulls and p-values are equal exactly
  (f64 on the same features and permutations; the same arithmetic as the
  multi-class permutation tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import folds as ref_folds
from repro.core import permutation as ref_permutation
from repro.launch.probe import layerwise_hidden_states as ref_layerwise_hidden_states
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import base
from repro_torch.core import folds, permutation
from repro_torch.launch import probe, serve
from repro_torch.models import convert, layers
from repro_torch.models import model as M
from repro_torch.models import transformer as T

ARCHS = ["gemma2-2b", "starcoder2-3b", "minicpm-2b", "internlm2-20b"]
TOL_LOGITS = 1e-4
TOL_KV_QUANT = 2e-2
BATCH, SEQ = 2, 24            # SEQ > gemma2-smoke's window of 16: the ring buffer wraps


def _close(got, want, tol):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


def _tokens(cfg, seed, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _models(arch, **overrides):
    cfg_ref = dataclasses.replace(ref_base.get_config(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(base.get_config(arch, smoke=True), **overrides)
    params_ref = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    return cfg_ref, params_ref, cfg, model


def _ref_layer_caches(cfg, caches):
    """The reference's {"stack": [...], "tail": [...]} caches, one dict per
    layer in layer order (repeat r of stack entry i is layer r·len + i)."""
    pat, n_rep, _ = RT._pattern_split(cfg)
    out = [None] * cfg.num_layers
    for i in range(len(pat)):
        for r in range(n_rep):
            out[r * len(pat) + i] = {k: v[r] for k, v in caches["stack"][i].items()}
    for j, c in enumerate(caches["tail"]):
        out[n_rep * len(pat) + j] = c
    return out


# ---------------------------------------------------------------- configs ----

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch, smoke):
    got, want = base.get_config(arch, smoke=smoke), ref_base.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_kinds == want.layer_kinds
    assert got.param_count() == want.param_count()


def test_registry_names_only_what_the_port_runs():
    # every family of the reference: dense here; MoE, RG-LRU, xLSTM, vision
    # and audio in test_torch_moe / _rglru / _xlstm / _modality
    assert base.list_archs() == ref_base.list_archs()
    assert set(ARCHS) < set(base.list_archs())
    with pytest.raises(KeyError, match="unknown arch"):
        base.get_config("gpt-2")
    cfg = base.apply_overrides(base.get_config("gemma2-2b"), ["num_layers=4", "kv_quant=true",
                                                              "norm_eps=1e-5"])
    want = ref_base.apply_overrides(ref_base.get_config("gemma2-2b"),
                                    ["num_layers=4", "kv_quant=true", "norm_eps=1e-5"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    # every smoke config initialises on the CPU; every full config builds
    # (on the meta device: llama-vision's 9.8 B weights are not allocated)
    for arch in base.list_archs():
        smoke_cfg, full_cfg = base.get_config(arch, smoke=True), base.get_config(arch)
        assert M.count_params(M.init_params(smoke_cfg, device="cpu")) > 0
        assert M.count_params(M.Model(full_cfg, "meta")) > 0


def test_other_families_raise_naming_the_roadmap():
    """Nothing is left to refuse: an unknown block kind raises ValueError in
    both packages, in the trunk and in its decode caches."""
    cfg = dataclasses.replace(base.get_config("gemma2-2b", smoke=True),
                              layer_pattern=("mamba", "local"))
    cfg_ref = dataclasses.replace(ref_base.get_config("gemma2-2b", smoke=True),
                                  layer_pattern=("mamba", "local"))
    with pytest.raises(ValueError, match="mamba"):
        M.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="mamba"):
        T.init_block_cache(cfg, "mamba", 1, 8, "cpu")
    with pytest.raises(ValueError, match="mamba"):
        RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    with pytest.raises(ValueError, match="mamba"):
        RT.init_block_cache(cfg_ref, "mamba", 1, 8)
    assert not hasattr(T, "check_supported")


# ------------------------------------------------------------------ model ----

def test_params_from_jax_carries_every_parameter():
    for arch in ARCHS:
        cfg_ref, params_ref, cfg, model = _models(arch)
        assert M.count_params(model) == RM.count_params(params_ref)
        assert (model.lm_head is None) == cfg.tie_embeddings
        pat, n_rep, _ = RT._pattern_split(cfg_ref)
        wq = np.asarray(params_ref["blocks"]["stack"][len(pat) - 1]["attn"]["wq"][n_rep - 1])
        assert np.array_equal(model.blocks.layers[n_rep * len(pat) - 1].attn.wq.numpy(), wq)
    tree = jax.tree.map(np.asarray, params_ref)
    tree["final_norm"] = {}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_jax(tree, cfg, device="cpu")


def test_init_params_is_seeded_and_shaped():
    cfg = base.get_config("internlm2-20b", smoke=True)
    a = M.init_params(cfg, device="cpu")
    b = M.init_params(cfg, device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
        assert not pa.requires_grad
    ref = RM.init_params(jax.random.PRNGKey(0), ref_base.get_config("internlm2-20b", smoke=True))
    assert M.count_params(a) == RM.count_params(ref)
    w = a.blocks.layers[0].attn.wq
    assert w.shape == (64, 4, 16) and float(w.abs().max()) <= 2.0 / 8.0 + 1e-7


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_the_reference(arch):
    cfg_ref, params_ref, cfg, model = _models(arch)
    toks = _tokens(cfg, 1)
    want, _, _ = RM.forward(params_ref, jnp.asarray(toks), cfg_ref)
    got, caches, aux = M.forward(model, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, TOL_LOGITS)
    assert caches is None

    last_ref, caches_ref = RM.prefill_step(params_ref, {"tokens": jnp.asarray(toks)}, cfg_ref)
    last, caches = M.prefill_step(model, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(last, last_ref, TOL_LOGITS)
    for got_c, want_c in zip(caches, _ref_layer_caches(cfg_ref, caches_ref), strict=True):
        assert set(got_c) == set(want_c) == {"k", "v"}
        for name in got_c:
            _close(got_c[name], want_c[name], TOL_LOGITS)


def test_dense_blocks_return_no_aux_loss():
    """A dense MLP block adds no aux term (an MoE block returns its loss), so
    its prefill and decode make no per-layer zero."""
    cfg = base.get_config("gemma2-2b", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = M.init_params(cfg, generator=gen, device="cpu")
    x = torch.randn(BATCH, SEQ, cfg.d_model, generator=gen).to(layers._dt(cfg))
    out, cache, aux = T.apply_block_full(model.blocks.layers[0], x, cfg,
                                         positions=torch.arange(SEQ)[None])
    assert aux is None and out.shape == x.shape and set(cache) == {"k", "v"}


def _decode_replay_ref(cfg_ref, params_ref, toks):
    caches = RT.init_trunk_cache(cfg_ref, toks.shape[0], toks.shape[1])
    decode = jax.jit(lambda tok, pos, c: RM.decode_step(params_ref, tok, pos, c, cfg_ref))
    out = []
    for t in range(toks.shape[1]):
        logits, caches = decode(jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32), caches)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1), caches


def _decode_replay(cfg, model, toks):
    caches = T.init_trunk_cache(cfg, toks.shape[0], toks.shape[1], "cpu")
    out = []
    for t in range(toks.shape[1]):
        logits, same = M.decode_step(model, torch.from_numpy(toks[:, t:t + 1]), t, caches, cfg)
        assert same is caches                        # updated in place
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), caches


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_replay_matches_the_reference_and_the_forward(arch):
    """Decode every position from empty caches: the logits equal the
    reference's decode and the port's own full forward."""
    cfg_ref, params_ref, cfg, model = _models(arch)
    toks = _tokens(cfg, 2)
    want, caches_ref = _decode_replay_ref(cfg_ref, params_ref, toks)
    got, caches = _decode_replay(cfg, model, toks)
    _close(got, want, TOL_LOGITS)
    full, _, _ = M.forward(model, torch.from_numpy(toks), cfg)
    _close(got, full, TOL_LOGITS)
    for got_c, want_c in zip(caches, _ref_layer_caches(cfg_ref, caches_ref), strict=True):
        for name in got_c:
            _close(got_c[name], want_c[name], TOL_LOGITS)


@pytest.mark.parametrize("arch", ["gemma2-2b", "internlm2-20b"])
def test_kv_quant_decode_matches_the_reference(arch):
    cfg_ref, params_ref, cfg, model = _models(arch, kv_quant=True)
    toks = _tokens(cfg, 3)
    want, caches_ref = _decode_replay_ref(cfg_ref, params_ref, toks)
    got, caches = _decode_replay(cfg, model, toks)
    _close(got, want, TOL_KV_QUANT)
    # decode caches: past the first layer each layer's input carries the
    # int8 flips of the layers before it, so its K/V are held at TOL_KV_QUANT
    for got_c, want_c in zip(caches, _ref_layer_caches(cfg_ref, caches_ref), strict=True):
        assert got_c["k"].dtype == torch.int8 and set(got_c) == set(want_c)
        for name in ("k", "v"):
            _close(layers.dequantize_kv(got_c[name], got_c[f"{name}_scale"], torch.float32),
                   np.asarray(want_c[name], np.float32) * np.asarray(want_c[f"{name}_scale"])[
                       ..., None], TOL_KV_QUANT)
    # prefill's quantised caches come from unquantised activations: codes
    # equal but for rounding-boundary flips of one step, scales at TOL_LOGITS
    _, pre_ref = RM.prefill_step(params_ref, {"tokens": jnp.asarray(toks)}, cfg_ref)
    _, pre = M.prefill_step(model, {"tokens": torch.from_numpy(toks)}, cfg)
    for got_c, want_c in zip(pre, _ref_layer_caches(cfg_ref, pre_ref), strict=True):
        for name in ("k", "v"):
            codes = np.abs(got_c[name].numpy().astype(int) - np.asarray(want_c[name], int))
            assert codes.max() <= 1 and (codes > 0).mean() < 0.01
            _close(got_c[f"{name}_scale"], want_c[f"{name}_scale"], TOL_LOGITS)


def test_quantize_kv_matches_the_reference():
    from repro.models import layers as RL
    t = np.random.default_rng(4).normal(size=(2, 5, 3, 16)).astype(np.float32)
    q_ref, s_ref = RL.quantize_kv(jnp.asarray(t))
    q, s = layers.quantize_kv(torch.from_numpy(t))
    assert np.array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(layers.dequantize_kv(q, s, torch.float32).numpy(),
                                  np.asarray(RL.dequantize_kv(q_ref, s_ref, jnp.float32)))


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(5)
    logits = (3 * rng.normal(size=(2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = RM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = M.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ serve ----

def _ref_generate(cfg_ref, params_ref, prompts, gen_len):
    """The reference launcher's loop (repro.launch.serve.main), for prompts
    within the local window."""
    b, s = prompts.shape
    last, pre = RM.prefill_step(params_ref, {"tokens": jnp.asarray(prompts)}, cfg_ref)
    caches = RT.init_trunk_cache(cfg_ref, b, s + gen_len)

    def graft(full, part):
        return jax.lax.dynamic_update_slice_in_dim(full, part.astype(full.dtype), 0, axis=2)

    caches = {"stack": [jax.tree.map(graft, f, p) for f, p in zip(caches["stack"], pre["stack"])],
              "tail": [jax.tree.map(lambda f, p: jax.lax.dynamic_update_slice_in_dim(
                  f, p.astype(f.dtype), 0, axis=1), f, p)
                  for f, p in zip(caches["tail"], pre["tail"])]}
    tok = jnp.argmax(last, axis=-1)[:, None]
    out = [tok]
    for step in range(gen_len - 1):
        logits, caches = RM.decode_step(params_ref, tok, jnp.asarray(s + step, jnp.int32),
                                        caches, cfg_ref)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=-1)), caches


@pytest.mark.parametrize("arch,kv_quant", [("gemma2-2b", False), ("starcoder2-3b", False),
                                           ("minicpm-2b", True)])
def test_generate_matches_the_reference_serve_loop(arch, kv_quant):
    cfg_ref, params_ref, cfg, model = _models(arch, kv_quant=kv_quant)
    prompts = _tokens(cfg, 6, batch=3, seq=12)
    want, caches_ref = _ref_generate(cfg_ref, params_ref, prompts, 8)
    got, stats = serve.generate(model, torch.from_numpy(prompts), 8, cfg)
    assert np.array_equal(got.numpy(), want)
    assert stats["decode_tokens"] == 3 * 7
    ref_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(caches_ref))
    assert stats["cache_bytes"] == ref_bytes


def test_serve_refuses_a_prompt_longer_than_the_local_window():
    cfg = base.get_config("gemma2-2b", smoke=True)
    model = M.init_params(cfg, device="cpu")
    prompts = torch.zeros((1, cfg.local_window + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="local_window"):
        serve.generate(model, prompts, 4, cfg)
    with pytest.raises(ValueError, match="local_window"):
        serve.main(["--smoke", "--device", "cpu", "--prompt-len", "17"])
    serve.check_prompt_len(cfg, cfg.local_window)                     # at the window: fine
    serve.check_prompt_len(base.get_config("starcoder2-3b", smoke=True), 10_000)  # no local


def test_place_prefill_fills_the_first_slots():
    cfg = base.get_config("gemma2-2b", smoke=True)
    model = M.init_params(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 7, batch=2, seq=10))
    _, pre = M.prefill_step(model, {"tokens": toks}, cfg)
    caches = serve.place_prefill(cfg, pre, 2, 40)
    for kind, full, part in zip(cfg.layer_kinds, caches, pre):
        cap = cfg.local_window if kind == "local" else 40
        assert full["k"].shape == (2, cap, cfg.num_kv_heads, cfg.head_dim)
        assert torch.equal(full["k"][:, :10], part["k"])
        assert not full["k"][:, 10:].any()


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--arch", "internlm2-20b", "--batch", "2",
                "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "decoded 6 tokens" in out and "cache footprint" in out


# ------------------------------------------------------------------ probe ----

@pytest.mark.parametrize("arch", ["gemma2-2b", "starcoder2-3b"])
def test_layerwise_hidden_states_match_the_reference(arch):
    cfg_ref, params_ref, cfg, model = _models(arch)
    toks = _tokens(cfg, 8, batch=5, seq=20)
    want = ref_layerwise_hidden_states(params_ref, jnp.asarray(toks), cfg_ref)
    got = probe.layerwise_hidden_states(model, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32
    assert got.shape == (RT._pattern_split(cfg_ref)[1], 5, cfg.d_model)
    _close(got, want, TOL_LOGITS)


def test_probe_equals_the_reference_on_its_features_and_permutations(monkeypatch):
    """Both packages' per-point permutation tests on the reference's
    features, with the reference's permutations (the port draws its own)."""
    cfg_ref, params_ref, cfg, model = _models("gemma2-2b")
    n_per, n_perm, k = 24, 40, 6
    rng = np.random.default_rng(9)
    half = cfg.vocab_size // 2
    toks = np.concatenate([rng.integers(0, half, (n_per, 16)),
                           rng.integers(half, cfg.vocab_size, (n_per, 16))]).astype(np.int32)
    y = np.concatenate([-np.ones(n_per), np.ones(n_per)])
    feats = np.array(ref_layerwise_hidden_states(params_ref, jnp.asarray(toks), cfg_ref))
    rf, tf = ref_folds.kfold(2 * n_per, k, seed=0), folds.kfold(2 * n_per, k, seed=0,
                                                                  device="cpu")
    want = [ref_permutation.analytical_permutation_binary(
        jnp.asarray(feats[li], jnp.float64), jnp.asarray(y), rf, 1.0, n_perm=n_perm,
        key=jax.random.PRNGKey(li), chunk=min(n_perm, 64)) for li in range(feats.shape[0])]
    ref_perms = {li: np.array(ref_permutation.permutation_indices(jax.random.PRNGKey(li),
                                                                  2 * n_per, n_perm))
                 for li in range(feats.shape[0])}
    monkeypatch.setattr(permutation, "permutation_indices",
                        lambda seed, n, t, device=None: torch.from_numpy(ref_perms[seed]))
    got = probe.probe_points(torch.from_numpy(feats), torch.from_numpy(y), tf, 1.0, n_perm)
    assert len(got) == len(want) == RT._pattern_split(cfg_ref)[1]
    for g, w in zip(got, want):
        assert float(g.observed) == float(w.observed)
        assert np.array_equal(g.null.numpy(), np.asarray(w.null))
        assert float(g.p) == float(w.p)


def test_probe_points_takes_one_lam_per_point():
    """A sequence of λ gives point li its own λ, with the permutations
    seeded by li as with one λ for all."""
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((3, 24, 40)))
    y = torch.from_numpy(np.repeat([-1.0, 1.0], 12))
    f = folds.kfold(24, 4, seed=0, device="cpu")
    lams = [0.5, 20.0, 400.0]
    got = probe.probe_points(feats, y, f, lams, 30)
    for li, g in enumerate(got):
        w = permutation.analytical_permutation_binary(feats[li], y, f, lams[li], 30, seed=li,
                                                      chunk=30)
        assert float(g.observed) == float(w.observed) and float(g.p) == float(w.p)
        assert torch.equal(g.null, w.null)
    same = probe.probe_points(feats, y, f, 20.0, 30)
    assert torch.equal(same[1].null, got[1].null)


def test_band_tokens_and_probe_cli(capsys):
    cfg = base.get_config("minicpm-2b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    toks, y = probe.band_tokens(cfg, 5, 7, gen)
    half = cfg.vocab_size // 2
    assert toks.shape == (10, 7) and bool((toks[:5] < half).all() and (toks[5:] >= half).all())
    assert y.tolist() == [-1.0] * 5 + [1.0] * 5
    probe.main(["--smoke", "--device", "cpu", "--arch", "minicpm-2b", "--n-per-class", "12",
                "--seq-len", "8", "--n-perm", "20"])
    out = capsys.readouterr().out
    assert "layers(points)=3" in out and out.count(" | ") >= 3 * 3
