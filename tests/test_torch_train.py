"""repro_torch's training step against the reference on the CPU: loss_fn and
its gradients for six families, three steps of make_train_step, µ-batching,
rematerialisation, and the repairs that training needed: the flash kernel
under autograd, out-of-place softcaps, serving without graphs.

The reference's parameters go through ``convert.params_from_jax`` and its
gradients through ``convert.tensors_from_jax``; batches come from both
packages' ``TokenStream`` (equal bit for bit).

Tolerances:
* loss 1e-5 relative; each gradient within 1e-5 of its own max |g|: the
  same f32 forward and backward summed in other orders. xlstm is held to
  1e-5 of the model's largest |g| instead: its sLSTM input-gate bias
  enters only through the stabilised exponent exp(i − m) while the input
  gate wins m = max(log f + m_prev, i), where the exact gradient is zero,
  so both packages return rounding noise there (3e-9 against a largest
  gradient of 0.67; the f32 trunk amplifies rounding, PERF.md §6).
* 3-step losses and grad norms 1e-5 relative: the optimizer moves every
  weight by about ±lr at step 1, so a gradient whose sign sits in rounding
  noise moves its weight the other way (measured on a CPU: losses 8e-8
  apart, grad norms 3e-7).
* µ = 2 against µ = 1 and the flash operator against autograd: 1e-6 of the max
  (f32 rounding of the halves' means; equal sums in another order).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data.tokens import TokenStream as RefTokenStream
from repro.data.tokens import TokenStreamConfig as RefTokenStreamConfig
from repro.models import model as RM
from repro.optim import optimizer as RO
from repro.train import steps as ref_steps
from repro_torch.configs import base
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import probe, serve
from repro_torch.models import convert, layers
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.train import steps

ARCHS = ["gemma2-2b", "olmoe-1b-7b", "recurrentgemma-2b", "xlstm-125m", "musicgen-medium",
         "llama-3.2-vision-11b"]
SEQ, BATCH = 16, 2
TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_ROUNDING = 1e-6


def _close(got, want, tol, scale=None, what=None):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30) if scale is None else scale
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (what, err, scale)


def _stream_cfg(cfg, seed=0, batch=BATCH, seq=SEQ):
    return dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed,
                num_codebooks=cfg.num_codebooks, vision_tokens=cfg.vision_tokens,
                vision_dim=cfg.vision_dim)


def _port(arch, params_ref, **overrides):
    cfg = dataclasses.replace(base.get_config(arch, smoke=True), **overrides)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    return cfg, model.requires_grad_(True)


@pytest.fixture(scope="module", params=ARCHS)
def ref_step1(request):
    """One reference value_and_grad per family on the stream's first batch:
    (arch, params, loss, metrics, grads)."""
    arch = request.param
    cfg_ref = ref_base.get_config(arch, smoke=True)
    params = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    batch = RefTokenStream(RefTokenStreamConfig(**_stream_cfg(cfg_ref))).next_batch()
    fn = jax.jit(jax.value_and_grad(functools.partial(RM.loss_fn, cfg=cfg_ref), has_aux=True))
    (loss, metrics), grads = fn(params, batch)
    return arch, params, loss, metrics, grads


def test_loss_and_step1_gradients_equal_the_reference(ref_step1):
    arch, params_ref, loss_ref, metrics_ref, grads_ref = ref_step1
    cfg, model = _port(arch, params_ref)
    batch = TokenStream(TokenStreamConfig(**_stream_cfg(cfg)), device="cpu").next_batch()
    loss, metrics, grads = steps.loss_and_grads(model, batch, cfg)
    assert cfg.remat                        # the smoke configs rematerialise
    _close(loss, loss_ref, TOL_LOSS, what="loss")
    _close(metrics["ce"], metrics_ref["ce"], TOL_LOSS, what="ce")
    _close(metrics["aux"], metrics_ref["aux"], TOL_LOSS,
           scale=max(float(metrics_ref["aux"]), 1e-3), what="aux")
    if cfg.moe_experts:
        assert float(metrics["aux"]) > 0
    want = convert.tensors_from_jax(jax.tree.map(np.asarray, grads_ref), cfg, device="cpu")
    assert list(grads) == list(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for name, g in grads.items():
        assert g.dtype == dict(model.named_parameters())[name].dtype
        _close(g, want[name], TOL_GRAD, scale=largest if arch == "xlstm-125m" else None,
               what=name)


def test_train_step_losses_over_three_steps_equal_the_reference():
    """gemma2's smoke model (both softcaps, local windows, tied embeddings)
    through make_train_step and the reference's, 3 steps on the stream."""
    arch = "gemma2-2b"
    cfg_ref = ref_base.get_config(arch, smoke=True)
    params_ref = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    cfg, model = _port(arch, params_ref)
    opt = O.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    ref_opt = RO.AdamWConfig(**dataclasses.asdict(opt))
    state_ref = RO.init_opt_state(params_ref, ref_opt)
    state = O.init_opt_state(steps.trainable(model), opt)
    step_ref = jax.jit(ref_steps.make_train_step(cfg_ref, ref_opt))
    step = steps.make_train_step(cfg, opt)
    stream_ref = RefTokenStream(RefTokenStreamConfig(**_stream_cfg(cfg_ref)))
    stream = TokenStream(TokenStreamConfig(**_stream_cfg(cfg)), device="cpu")
    for _ in range(3):
        params_ref, state_ref, m_ref = step_ref(params_ref, state_ref, stream_ref.next_batch())
        m = step(model, state, stream.next_batch())
        assert set(m) == set(m_ref) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for key in ("loss", "ce", "grad_norm"):
            _close(m[key], m_ref[key], TOL_LOSS, what=key)
        _close(m["lr"], m_ref["lr"], TOL_ROUNDING, what="lr")
    assert int(state.step) == 3


def _step_grads(arch, microbatches=1, **overrides):
    cfg = dataclasses.replace(base.get_config(arch, smoke=True), **overrides)
    gen = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, generator=gen, device="cpu").requires_grad_(True)
    batch = TokenStream(TokenStreamConfig(**_stream_cfg(cfg, batch=4)), device="cpu").next_batch()
    return steps.loss_and_grads(model, batch, cfg, microbatches=microbatches)


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_two_microbatches_equal_one_batch(arch):
    """µ = 2 accumulates in f32 outside .grad and divides by 2: the loss, its
    parts and every gradient equal one batch's to f32 rounding. olmoe runs
    at a no-drop capacity and without its load-balancing loss: that loss is
    a product of batch means, so its mean over two halves is another
    function than over the batch, in the reference as here."""
    kw = ({"moe_capacity_factor": 8.0, "moe_aux_loss_coef": 0.0} if arch == "olmoe-1b-7b"
          else {})
    loss1, m1, g1 = _step_grads(arch, **kw)
    loss2, m2, g2 = _step_grads(arch, microbatches=2, **kw)
    _close(loss2, loss1, TOL_ROUNDING, what="loss")
    _close(m2["ce"], m1["ce"], TOL_ROUNDING, what="ce")
    for name in g1:
        assert g2[name].dtype == torch.float32
        _close(g2[name], g1[name], TOL_ROUNDING, what=name)


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b", "llama-3.2-vision-11b"])
def test_remat_equals_the_plain_backward(arch):
    """torch.utils.checkpoint per layer recomputes the same forward: the loss
    and every gradient equal the unrematerialised run's bit for bit."""
    loss_r, _, g_r = _step_grads(arch, remat=True)
    loss_p, _, g_p = _step_grads(arch, remat=False)
    assert torch.equal(loss_r, loss_p)
    for name in g_r:
        assert torch.equal(g_r[name], g_p[name]), name


def test_remat_keeps_only_layer_inputs(monkeypatch):
    """With remat each layer's forward runs twice (forward and recompute),
    without it once; in serving (no grad, or no parameter requiring grad)
    once either way."""
    from repro_torch.models import transformer

    calls = []
    block = transformer.apply_block_full

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return block(*a, **kw)

    checkpointed = []
    checkpoint = transformer.checkpoint

    def counted_checkpoint(*a, **kw):
        checkpointed.append(None)
        return checkpoint(*a, **kw)

    monkeypatch.setattr(transformer, "apply_block_full", counted)
    monkeypatch.setattr(transformer, "checkpoint", counted_checkpoint)
    cfg = base.get_config("gemma2-2b", smoke=True)
    for remat, want in ((True, 2), (False, 1)):
        calls.clear()
        checkpointed.clear()
        _step_grads("gemma2-2b", remat=remat)
        assert len(calls) == want * cfg.num_layers
        assert len(checkpointed) == (cfg.num_layers if remat else 0)
    checkpointed.clear()
    calls.clear()
    model = M.init_params(cfg, device="cpu").requires_grad_(True)
    with torch.no_grad():
        M.forward(model, torch.zeros((1, 8), dtype=torch.int64), cfg)
    assert len(calls) == cfg.num_layers
    calls.clear()
    M.forward(model.requires_grad_(False), torch.zeros((1, 8), dtype=torch.int64), cfg)
    assert calls == [True] * cfg.num_layers and not checkpointed   # grad on, no graph


# ------------------------------------------- the flash kernel under autograd --

def _ref_launch(q, k, v, **kw):
    """attention_ref in the launch's place, carrying no graph, as the
    kernel's output carries none."""
    with torch.no_grad():
        return attention_ref(q, k, v, **kw)


@pytest.mark.parametrize("window,softcap,hkv", [(None, None, 4), (5, 50.0, 2), (3, None, 1)])
def test_flash_function_gradients_equal_autograd_through_attention_ref(monkeypatch, window,
                                                                       softcap, hkv):
    monkeypatch.setattr(ops, "_kernel", _ref_launch)
    rng = np.random.default_rng(0)
    q0, k0, v0 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 4, 12, 16), (2, hkv, 12, 16), (2, hkv, 12, 16)))
    dout = torch.from_numpy(rng.standard_normal((2, 4, 12, 16)).astype(np.float32))
    kw = dict(scale=0.25, causal=True, window=window, softcap=softcap)

    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    out = ops.flash_attention_op(q, k, v, *kw.values())
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q0, k0, v0))
    out_ref = attention_ref(qr, kr, vr, **kw)
    want = torch.autograd.grad(out_ref, (qr, kr, vr), dout)
    assert torch.equal(out, out_ref)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # under no_grad: the same single launch, no graph
    with torch.no_grad():
        assert ops.flash_attention_op(q, k, v, *kw.values()).grad_fn is None


def _gemma2_grads(monkeypatch, attention):
    cfg_ref = ref_base.get_config("gemma2-2b", smoke=True)
    cfg, model = _port("gemma2-2b", RM.init_params(jax.random.PRNGKey(0), cfg_ref))
    if attention is not None:
        monkeypatch.setattr(layers, "flash_attention", attention)
    batch = TokenStream(TokenStreamConfig(**_stream_cfg(cfg)), device="cpu").next_batch()
    with torch.enable_grad():
        loss, _ = M.loss_fn(model, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return loss, dict(zip(names, grads))


def test_bare_kernel_output_drops_attention_gradients(monkeypatch):
    """The fault the flash operator repairs: a launch's output has no grad_fn, so
    the projections feeding attention get no gradient at all."""
    _, grads = _gemma2_grads(monkeypatch, _ref_launch)
    for i in range(4):
        for w in ("wq", "wk", "wv"):
            assert grads[f"blocks.layers.{i}.attn.{w}"] is None
        assert grads[f"blocks.layers.{i}.attn.wo"] is not None


def test_gemma2_gradients_through_the_function_equal_plain_attention(monkeypatch):
    """The smoke model's loss gradients with attention through the flash operator
    (the stand-in launch forward, attention_ref's gradient backward) equal
    those without the kernel (autograd through attention_ref)."""
    loss_plain, plain = _gemma2_grads(monkeypatch, None)
    monkeypatch.setattr(ops, "_kernel", _ref_launch)
    loss_fn, through = _gemma2_grads(
        monkeypatch, lambda q, k, v, **kw: ops.flash_attention_op(q, k, v, *kw.values()))
    assert torch.equal(loss_fn, loss_plain)
    for name, g in plain.items():
        assert through[name] is not None, name
        _close(through[name], g, TOL_ROUNDING, what=name)


# -------------------------------------------------------------- softcaps ----

def test_in_place_softcap_breaks_backward(monkeypatch):
    """The fault: tanh_ saves its output for the backward and mul_ then
    overwrites it. With the in-place form put back, backward through the
    gemma2 smoke model raises; with the repair it runs."""
    x = torch.randn(4, 8, requires_grad=True)
    layers.softcap_(x * 2.0, 30.0).sum().backward()
    assert x.grad is not None
    cfg = base.get_config("gemma2-2b", smoke=True)
    model = M.init_params(cfg, device="cpu").requires_grad_(True)
    batch = TokenStream(TokenStreamConfig(**_stream_cfg(cfg)), device="cpu").next_batch()
    M.loss_fn(model, batch, cfg)[0].backward()
    monkeypatch.setattr(layers, "softcap_", lambda t, c: t.div_(c).tanh_().mul_(c))
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        M.loss_fn(model, batch, cfg)[0].backward()


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama-3.2-vision-11b"])
def test_softcaps_give_the_same_logits_with_and_without_a_graph(arch):
    """gemma2's final softcap and the cross attention's logit softcap (set on
    the vision smoke model): the out-of-place form under a gradient gives
    the in-place form's logits bit for bit, and backward runs."""
    overrides = {"attn_logit_softcap": 20.0} if arch.startswith("llama") else {}
    cfg = dataclasses.replace(base.get_config(arch, smoke=True), **overrides)
    gen = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, generator=gen, device="cpu")
    with torch.no_grad():   # a fresh cross block is the identity: open its gates
        for i, kind in enumerate(cfg.layer_kinds):
            if kind == "cross":
                model.blocks.layers[i].gate_attn.fill_(0.8)
    batch = TokenStream(TokenStreamConfig(**_stream_cfg(cfg)), device="cpu").next_batch()
    vis = batch.get("vision_embeds")
    with torch.no_grad():
        want = M.forward(model, batch["tokens"], cfg, vision_embeds=vis)[0]
    model.requires_grad_(True)
    got = M.forward(model, batch["tokens"], cfg, vision_embeds=vis)[0]
    assert got.grad_fn is not None
    assert torch.equal(got, want)
    got.sum().backward()
    assert model.embed["tokens"].grad is not None


def test_softcap_helpers_give_equal_bits_in_both_forms():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 80)
    xg = x.clone().requires_grad_()
    assert torch.equal(layers.softcap_(x.clone(), 30.0), layers.softcap_(xg, 30.0))
    assert torch.equal(layers.scale_(x.clone(), 0.25), layers.scale_(xg, 0.25))


# --------------------------------------------------- serving without graphs --

def test_serving_a_model_that_requires_grad_builds_no_graph():
    """generate and the probe's hidden states run under no_grad: a model
    switched on for training serves and probes with the same outputs, none
    of which carries a graph."""
    cfg = base.get_config("gemma2-2b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, generator=gen, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    ids, _ = serve.generate(model, prompts, 6, cfg)
    feats = probe.layerwise_hidden_states(model, prompts, cfg)
    model.requires_grad_(True)
    # the fault: outside no_grad, a model switched on for training records a
    # graph in every call
    assert M.prefill_step(model, {"tokens": prompts}, cfg)[0].grad_fn is not None
    ids_g, _ = serve.generate(model, prompts, 6, cfg)
    feats_g = probe.layerwise_hidden_states(model, prompts, cfg)
    assert torch.equal(ids, ids_g) and torch.equal(feats, feats_g)
    assert ids_g.grad_fn is None and feats_g.grad_fn is None and not feats_g.requires_grad
    last, caches = steps.make_prefill_step(cfg)(model, {"tokens": prompts})
    assert last.grad_fn is None and all(t.grad_fn is None for c in caches for t in c.values())
    last2, caches2 = steps.make_prefill_step(cfg, microbatches=2)(model, {"tokens": prompts})
    assert len(caches2) == 2 and torch.allclose(last2, last, rtol=0, atol=1e-5)
    assert torch.equal(caches2[1][0]["k"], caches[0]["k"][1:])
    full = serve.place_prefill(cfg, caches, 2, 9)
    logits, _ = steps.make_decode_step(cfg)(model, ids[:, :1], 8, full)
    assert logits.grad_fn is None
