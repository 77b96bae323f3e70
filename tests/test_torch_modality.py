"""repro_torch's modality stubs against the reference on the CPU: vision
cross attention (llama-3.2-vision-11b) and audio codebooks with sinusoidal
positions (musicgen-medium).

Smoke configs in f32, with the reference's parameters through
``convert.params_from_jax``; token and patch-embedding inputs made with
numpy from a seed. Tolerance: 1e-5 of the largest magnitude of the
reference's result. Greedy generation is compared token for token.

A cross block scales its attention and MLP by tanh of its gates, which
are zero at init: a fresh cross block is the identity in both packages
(``test_cross_block_at_zero_gates_is_the_identity``). Every other vision
test plants the named non-zero gates ``GATE_ATTN`` and ``GATE_MLP`` in the
reference's parameters before both models are built from them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch.probe import layerwise_hidden_states as ref_layerwise_hidden_states
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch.configs import base
from repro_torch.launch import probe, serve
from repro_torch.models import convert, layers
from repro_torch.models import model as M
from repro_torch.models import transformer as T

VISION, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
TOL = 1e-5
BATCH, SEQ = 2, 24
GATE_ATTN, GATE_MLP = 0.8, -0.6


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


def _build(arch, **overrides):
    cfg_ref = dataclasses.replace(ref_base.get_config(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(base.get_config(arch, smoke=True), **overrides)
    params_ref = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    for stacked in params_ref["blocks"]["stack"]:
        if "gate_attn" in stacked:        # the planted gates (zero at init)
            stacked["gate_attn"] = jnp.full_like(stacked["gate_attn"], GATE_ATTN)
            stacked["gate_mlp"] = jnp.full_like(stacked["gate_mlp"], GATE_MLP)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    return cfg_ref, params_ref, cfg, model


@pytest.fixture(scope="module")
def vision():
    return _build(VISION)


@pytest.fixture(scope="module")
def audio():
    return _build(AUDIO)


def _tokens(cfg, seed, batch=BATCH, seq=SEQ):
    shape = (batch, cfg.num_codebooks, seq) if cfg.num_codebooks else (batch, seq)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _patches(cfg, seed, batch=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)


def _ref_layer_caches(cfg, caches):
    """The reference's {"stack", "tail"} caches as one dict per layer."""
    pat, n_rep, _ = RT._pattern_split(cfg)
    out = [None] * cfg.num_layers
    for i in range(len(pat)):
        for r in range(n_rep):
            out[r * len(pat) + i] = {k: v[r] for k, v in caches["stack"][i].items()}
    for j, c in enumerate(caches["tail"]):
        out[n_rep * len(pat) + j] = c
    return out


# ------------------------------------------------------------------ configs --

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_configs_equal_the_reference_field_for_field(arch, smoke):
    got, want = base.get_config(arch, smoke=smoke), ref_base.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_kinds == want.layer_kinds
    assert got.param_count() == want.param_count()


def test_vision_params_follow_the_reference_keys_and_init(vision):
    cfg_ref, params_ref, cfg, model = vision
    assert M.count_params(model) == RM.count_params(params_ref)
    names = {n for n, _ in model.named_parameters()}
    assert {"vision_proj.w", "blocks.layers.4.gate_attn", "blocks.layers.4.gate_mlp",
            "blocks.layers.4.attn.wk", "lm_head"} <= names
    assert not any(n.startswith("blocks.layers.3.gate") for n in names)
    assert model.blocks.layers[4].attn.wk.shape == (cfg.d_model, cfg.num_kv_heads, cfg.head_dim)
    assert float(model.blocks.layers[4].gate_attn) == pytest.approx(GATE_ATTN)
    fresh = M.init_params(cfg, device="cpu")
    assert float(fresh.blocks.layers[4].gate_attn) == float(fresh.blocks.layers[4].gate_mlp) == 0
    assert fresh.vision_proj["w"].shape == (cfg.vision_dim, cfg.d_model)


def test_audio_params_follow_the_reference_keys(audio):
    cfg_ref, params_ref, cfg, model = audio
    assert M.count_params(model) == RM.count_params(params_ref)
    names = {n for n, _ in model.named_parameters()}
    assert {"embed.codebook_0", "embed.codebook_1", "lm_head_0", "lm_head_1",
            "final_norm.bias"} <= names
    assert "embed.tokens" not in names and model.lm_head is None
    assert [h.shape for h in model.heads()] == [(cfg.d_model, cfg.vocab_size)] * 2


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cross_cache_holds_the_vision_tokens_unquantized(kv_quant):
    cfg = dataclasses.replace(base.get_config(VISION, smoke=True), kv_quant=kv_quant)
    cfg_ref = dataclasses.replace(ref_base.get_config(VISION, smoke=True), kv_quant=kv_quant)
    for kind in ("attn", "cross"):
        got = T.init_block_cache(cfg, kind, 3, 40, "cpu")
        want = RT.init_block_cache(cfg_ref, kind, 3, 40)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert T.init_block_cache(cfg, "cross", 3, 40, "cpu")["k"].shape[1] == cfg.vision_tokens


# ------------------------------------------------------------------ layers --

@pytest.mark.parametrize("shape", [(SEQ,), (BATCH, SEQ), (BATCH, 1)],
                         ids=["S", "B_S", "decode_position"])
def test_sinusoidal_matches_the_reference(shape):
    pos = np.random.default_rng(1).integers(0, 5000, shape).astype(np.int32)
    if shape == (BATCH, 1):
        pos[:] = 4097                                  # one decode position for the batch
    got = layers.sinusoidal(torch.from_numpy(pos).long(), 64)
    want = RL.sinusoidal(jnp.asarray(pos), 64)
    assert got.dtype == torch.float32
    _close(got, want)


def _cross_layer(vision):
    cfg_ref, params_ref, cfg, model = vision
    p_ref = jax.tree.map(lambda t: t[0], params_ref["blocks"]["stack"][4])
    return cfg_ref, p_ref, cfg, model.blocks.layers[4]


def test_attention_full_with_kv_src_matches_the_reference(vision):
    cfg_ref, p_ref, cfg, blk = _cross_layer(vision)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((BATCH, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    pos = np.arange(SEQ, dtype=np.int32)[None]
    got, (k, v) = layers.attention_full(blk.attn, torch.from_numpy(x), cfg,
                                        positions=torch.from_numpy(pos).long(),
                                        kv_src=torch.from_numpy(src))
    want, (k_ref, v_ref) = RL.attention_full(p_ref["attn"], jnp.asarray(x), cfg_ref,
                                             positions=jnp.asarray(pos), kv_src=jnp.asarray(src))
    _close(got, want)
    assert k.shape == (BATCH, cfg.vision_tokens, cfg.num_kv_heads, cfg.head_dim)
    _close(k, k_ref)
    _close(v, v_ref)


def test_cross_attention_decode_matches_the_reference(vision):
    cfg_ref, p_ref, cfg, blk = _cross_layer(vision)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((BATCH, cfg.vision_tokens, cfg.num_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    ck_t, cv_t = torch.from_numpy(ck), torch.from_numpy(cv)
    got = layers.cross_attention_decode(blk.attn, torch.from_numpy(x), cfg, cross_k=ck_t,
                                        cross_v=cv_t)
    want = RL.cross_attention_decode(p_ref["attn"], jnp.asarray(x), cfg_ref,
                                     cross_k=jnp.asarray(ck), cross_v=jnp.asarray(cv))
    _close(got, want)
    assert np.array_equal(ck_t.numpy(), ck) and np.array_equal(cv_t.numpy(), cv)


def test_cross_block_at_zero_gates_is_the_identity():
    """With the gates as initialised (0), both sub-blocks are scaled by
    tanh(0) = 0: the cross block returns its input, in both packages."""
    cfg_ref = ref_base.get_config(VISION, smoke=True)
    cfg = base.get_config(VISION, smoke=True)
    params_ref = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    p_ref = jax.tree.map(lambda t: t[0], params_ref["blocks"]["stack"][4])
    assert float(p_ref["gate_attn"]) == float(model.blocks.layers[4].gate_mlp) == 0.0
    rng = np.random.default_rng(4)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    vis = rng.standard_normal((BATCH, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    pos = np.arange(SEQ, dtype=np.int32)[None]
    got, cache, _ = T.apply_block_full(model.blocks.layers[4], torch.from_numpy(x), cfg,
                                       positions=torch.from_numpy(pos).long(),
                                       vis_kv=torch.from_numpy(vis))
    want, _, _ = RT.apply_block_full(p_ref, jnp.asarray(x), "cross", cfg_ref,
                                     positions=jnp.asarray(pos), vis_kv=jnp.asarray(vis))
    assert np.array_equal(got.numpy(), x) and np.array_equal(np.asarray(want), x)
    assert cache["k"].any()                            # the cache is the vision K/V all the same


def test_cross_block_needs_vision_embeds(vision):
    _, _, cfg, model = vision
    with pytest.raises(ValueError, match="vision_embeds"):
        M.forward(model, torch.from_numpy(_tokens(cfg, 5)).long(), cfg)


# ------------------------------------------------------------------ vision --

def test_vision_forward_and_prefill_match_the_reference(vision):
    cfg_ref, params_ref, cfg, model = vision
    toks, vis = _tokens(cfg, 6), _patches(cfg, 7)
    want, _, _ = RM.forward(params_ref, jnp.asarray(toks), cfg_ref, vision_embeds=jnp.asarray(vis))
    got, _, _ = M.forward(model, torch.from_numpy(toks), cfg, vision_embeds=torch.from_numpy(vis))
    _close(got, want)
    batch_ref = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis)}
    last_ref, caches_ref = RM.prefill_step(params_ref, batch_ref, cfg_ref)
    last, caches = M.prefill_step(model, {"tokens": torch.from_numpy(toks),
                                          "vision_embeds": torch.from_numpy(vis)}, cfg)
    _close(last, last_ref)
    for kind, got_c, want_c in zip(cfg.layer_kinds, caches, _ref_layer_caches(cfg_ref, caches_ref),
                                   strict=True):
        cap = cfg.vision_tokens if kind == "cross" else SEQ
        assert got_c["k"].shape[1] == cap
        for name in ("k", "v"):
            _close(got_c[name], want_c[name])
    # without the gates planted the trunk's output would not depend on vis
    other, _, _ = M.forward(model, torch.from_numpy(toks), cfg,
                            vision_embeds=torch.from_numpy(_patches(cfg, 8)))
    assert not torch.allclose(other, got)


def _ref_generate(cfg_ref, params_ref, prompts, gen_len, vis=None):
    """The reference launcher's loop (repro.launch.serve.main) on these
    prompts and patch embeddings."""
    b, s = prompts.shape[0], prompts.shape[-1]
    batch = {"tokens": jnp.asarray(prompts)}
    if vis is not None:
        batch["vision_embeds"] = jnp.asarray(vis)
    last, pre = RM.prefill_step(params_ref, batch, cfg_ref)
    caches = RT.init_trunk_cache(cfg_ref, b, s + gen_len)

    def graft(axis):
        return lambda full, part: jax.lax.dynamic_update_slice_in_dim(
            full, part.astype(full.dtype), 0, axis=axis)

    caches = {"stack": [jax.tree.map(graft(2), f, p) for f, p in zip(caches["stack"],
                                                                     pre["stack"])],
              "tail": [jax.tree.map(graft(1), f, p) for f, p in zip(caches["tail"], pre["tail"])]}
    step = jax.jit(lambda tok, pos, c: RM.decode_step(params_ref, tok, pos, c, cfg_ref))
    codebooks = bool(cfg_ref.num_codebooks)
    tok = jnp.argmax(last, axis=-1)[..., None]
    out = [tok]
    for t in range(gen_len - 1):
        logits, caches = step(tok, jnp.asarray(s + t, jnp.int32), caches)
        tok = jnp.argmax(logits[:, 0] if codebooks else logits[:, -1], axis=-1)[..., None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=-1)), caches


@pytest.mark.parametrize("kv_quant", [False, True])
def test_vision_generate_matches_the_reference_serve_loop(kv_quant):
    cfg_ref, params_ref, cfg, model = _build(VISION, kv_quant=kv_quant)
    prompts, vis = _tokens(cfg, 9, batch=3, seq=12), _patches(cfg, 10, batch=3)
    want, caches_ref = _ref_generate(cfg_ref, params_ref, prompts, 8, vis)
    got, stats = serve.generate(model, torch.from_numpy(prompts), 8, cfg,
                                vision_embeds=torch.from_numpy(vis))
    assert got.shape == (3, 8)
    assert np.array_equal(got.numpy(), want)
    ref_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(caches_ref))
    assert stats["cache_bytes"] == ref_bytes
    # the cross caches placed from the prefill: unquantized, every slot filled
    _, pre = M.prefill_step(model, {"tokens": torch.from_numpy(prompts),
                                    "vision_embeds": torch.from_numpy(vis)}, cfg)
    placed = serve.place_prefill(cfg, pre, 3, 20)
    assert placed[4]["k"].dtype == torch.float32 and set(placed[4]) == {"k", "v"}
    assert torch.equal(placed[4]["k"], pre[4]["k"])
    assert (placed[0]["k"].dtype == torch.int8) == kv_quant


def test_vision_probe_features_match_the_reference(vision):
    cfg_ref, params_ref, cfg, model = vision
    toks, vis = _tokens(cfg, 11, batch=5, seq=20), _patches(cfg, 12, batch=5)
    want = ref_layerwise_hidden_states(params_ref, jnp.asarray(toks), cfg_ref,
                                       vision_embeds=jnp.asarray(vis))
    got = probe.layerwise_hidden_states(model, torch.from_numpy(toks), cfg,
                                        vision_embeds=torch.from_numpy(vis))
    assert got.shape == (1, 5, cfg.d_model)
    _close(got, want)


# ------------------------------------------------------------------- audio --

def test_audio_forward_and_prefill_match_the_reference(audio):
    cfg_ref, params_ref, cfg, model = audio
    toks = _tokens(cfg, 13)
    want, _, _ = RM.forward(params_ref, jnp.asarray(toks), cfg_ref)
    got, _, _ = M.forward(model, torch.from_numpy(toks), cfg)
    assert got.shape == (BATCH, SEQ, cfg.num_codebooks, cfg.vocab_size)
    _close(got, want)
    last_ref, _ = RM.prefill_step(params_ref, {"tokens": jnp.asarray(toks)}, cfg_ref)
    last, _ = M.prefill_step(model, {"tokens": torch.from_numpy(toks)}, cfg)
    assert last.shape == (BATCH, cfg.num_codebooks, cfg.vocab_size)
    _close(last, last_ref)


def test_audio_decode_from_empty_caches_matches_the_forward(audio):
    """Decode at each position adds that position's sinusoid: the replay
    equals the forward."""
    _, _, cfg, model = audio
    toks = torch.from_numpy(_tokens(cfg, 14))
    caches = T.init_trunk_cache(cfg, BATCH, SEQ, "cpu")
    got = torch.stack([M.decode_step(model, toks[..., t:t + 1], t, caches, cfg)[0][:, 0]
                       for t in range(SEQ)], dim=1)
    _close(got, M.forward(model, toks, cfg)[0].numpy())


def test_audio_generate_matches_the_reference_serve_loop(audio):
    cfg_ref, params_ref, cfg, model = audio
    prompts = _tokens(cfg, 15, batch=3, seq=12)
    want, _ = _ref_generate(cfg_ref, params_ref, prompts, 8)
    got, stats = serve.generate(model, torch.from_numpy(prompts), 8, cfg)
    assert got.shape == (3, cfg.num_codebooks, 8)
    assert np.array_equal(got.numpy(), want)
    assert stats["decode_tokens"] == 3 * 7


def test_audio_probe_features_on_tiled_codebooks_match_the_reference(audio):
    cfg_ref, params_ref, cfg, model = audio
    gen = torch.Generator().manual_seed(0)
    band, _ = probe.band_tokens(cfg, 3, 20, gen)
    toks, vis = probe.probe_inputs(cfg, band, gen)
    assert vis is None and toks.shape == (6, cfg.num_codebooks, 20)
    assert all(torch.equal(toks[:, i], band) for i in range(cfg.num_codebooks))
    want = ref_layerwise_hidden_states(params_ref, jnp.asarray(toks.numpy()), cfg_ref)
    got = probe.layerwise_hidden_states(model, toks, cfg)
    assert got.shape == (cfg.num_layers, 6, cfg.d_model)
    _close(got, want)


# ------------------------------------------------------------------ launch --

@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--smoke", "--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "decoded 6 tokens" in out and "cache footprint" in out


@pytest.mark.parametrize("arch,points", [(VISION, 1), (AUDIO, 3)])
def test_probe_cli_runs_on_the_cpu(arch, points, capsys):
    probe.main(["--smoke", "--device", "cpu", "--arch", arch, "--n-per-class", "12",
                "--seq-len", "8", "--n-perm", "20"])
    out = capsys.readouterr().out
    assert f"layers(points)={points}" in out and out.count(" | ") >= 3 * points
