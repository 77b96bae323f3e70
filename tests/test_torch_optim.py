"""repro_torch.optim against the reference on the CPU: the learning-rate
schedules, int8 error-feedback compression and AdamW's apply_updates.

The optimizer is held to the reference by feeding both packages the same
gradients, taken from the reference (``jax.grad`` of its ``loss_fn``) and
carried across by ``convert.tensors_from_jax``: Adam divides by sqrt(v), so
at step 1 every weight moves by about ±lr whatever its gradient's size, and
a gradient whose sign sits in rounding noise would flip a weight by 2·lr.

Tolerances:
* schedules: 1e-6 of lr_peak. The port computes in f32 from an f32 step;
  the reference, under this suite's x64 setting, in f64.
* compression: equal bit for bit (the same f32 operations; both round half
  to even).
* apply_updates: params, master, mu and nu within 1e-6 of each tensor's
  max |·| after each of 3 steps; step exact. When the clip is active, the
  gradients the moments take are scaled by clip_norm / grad_norm, and the
  two packages' f32 grad norms differ by δ (the reference's is the further
  from the f64 norm: 4e-7 to 6e-7 of it here, the port's 5e-8 to 7e-8), so
  mu is held to 1e-6 + δ and nu (squares) to 1e-6 + 2δ, with δ ≤ 1e-6
  asserted on its own. The master and the parameters move by m / sqrt(v),
  where the scale cancels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data.tokens import TokenStream as RefTokenStream
from repro.data.tokens import TokenStreamConfig as RefTokenStreamConfig
from repro.models import model as RM
from repro.optim import compression as ref_compression
from repro.optim import optimizer as RO
from repro_torch.configs import base
from repro_torch.models import convert, transformer
from repro_torch.optim import compression
from repro_torch.optim import optimizer as O
from repro_torch.train import steps

ARCH = "gemma2-2b"
N_STEPS = 3
TOL_LR = 1e-6
TOL_STATE = 1e-6


def _close(got, want, tol, what=None):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


# -------------------------------------------------------------- schedules ----

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_equal_the_reference_at_every_step(schedule):
    cfg = O.AdamWConfig(lr_peak=3e-3, warmup_steps=10, total_steps=100, decay_frac=0.2,
                        schedule=schedule)
    ref_cfg = RO.AdamWConfig(**dataclasses.asdict(cfg))
    for step in range(101):
        got = O.learning_rate(torch.tensor(step, dtype=torch.int32), cfg)
        want = float(RO._lr(jnp.asarray(step, jnp.int32), ref_cfg))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= TOL_LR * cfg.lr_peak, (step, float(got), want)
        assert float(O.learning_rate(step, cfg)) == float(got)      # a Python int too


def test_wsd_schedule_shape():
    """The reference's shape test (test_train_infra) on the port."""
    cfg = O.AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=100, decay_frac=0.2,
                        schedule="wsd")
    lrs = [float(O.wsd_schedule(s, cfg)) for s in range(100)]
    assert lrs[0] < 0.2
    assert abs(lrs[50] - 1.0) < 1e-6
    assert lrs[-1] < 0.5
    assert all(lr <= 1.0 + 1e-6 for lr in lrs)


# ------------------------------------------------------------ compression ----

def test_quantize_int8_equals_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal((64, 64)).astype(np.float32),
              (rng.standard_normal(1000) * 1e-20).astype(np.float32),
              np.zeros(5, np.float32),
              np.array([0.5, -0.5, 1.5, 2.5, -127.0], np.float32)):
        q, s = compression.quantize_int8(torch.from_numpy(x))
        q_ref, s_ref = ref_compression.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        assert s.item() == float(s_ref)
        np.testing.assert_array_equal(compression.dequantize_int8(q, s).numpy(),
                                      np.asarray(ref_compression.dequantize_int8(q_ref, s_ref)))


def test_compress_decompress_equals_the_reference_over_20_rounds():
    """Error feedback over 20 rounds, two tensors of different scales: the
    dequantised gradients and the errors equal the reference's bit for bit,
    and the accumulated gradients converge to the true ones (the reference's
    test_int8_compression_error_feedback_preserves_signal)."""
    rng = np.random.default_rng(1)
    gs = {"a": rng.standard_normal((64, 64)).astype(np.float32),
          "b": (rng.standard_normal((7, 3)) * 1e-3).astype(np.float32)}
    err = {k: torch.zeros(v.shape) for k, v in gs.items()}
    err_ref = {k: jnp.zeros(v.shape, jnp.float32) for k, v in gs.items()}
    total = {k: torch.zeros(v.shape) for k, v in gs.items()}
    for _ in range(20):
        deq, err = compression.compress_decompress({k: torch.from_numpy(v) for k, v in gs.items()},
                                                   err)
        deq_ref, err_ref = ref_compression.compress_decompress(
            {k: jnp.asarray(v) for k, v in gs.items()}, err_ref)
        for k in gs:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(deq_ref[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(err_ref[k]))
            total[k] += deq[k]
    for k, g in gs.items():
        acc = torch.from_numpy(g) * 20
        assert float(torch.linalg.norm(total[k] - acc) / torch.linalg.norm(acc)) < 0.01


# ---------------------------------------------------------- apply_updates ----

@pytest.fixture(scope="module")
def ref_grads():
    """The reference's smoke gemma2 parameters and the gradients of its
    loss_fn on 3 batches of the token stream, at the parameters each step
    of the reference's own optimizer reaches (clip_norm 1, no compression);
    the same gradients feed every case below."""
    cfg_ref = ref_base.get_config(ARCH, smoke=True)
    params = RM.init_params(jax.random.PRNGKey(0), cfg_ref)
    stream = RefTokenStream(RefTokenStreamConfig(cfg_ref.vocab_size, 16, 2, seed=0))
    grad_fn = jax.jit(jax.grad(lambda p, b: RM.loss_fn(p, b, cfg_ref)[0]))
    opt = RO.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    state = RO.init_opt_state(params, opt)
    p, grads = params, []
    for _ in range(N_STEPS):
        g = grad_fn(p, stream.next_batch())
        grads.append(g)
        p, state, _ = RO.apply_updates(p, g, state, opt)
    return params, grads


def _check_state(model, state, params_ref, state_ref, cfg, delta=0.0):
    flat = lambda tree: convert.flat_from_jax(jax.tree.map(np.asarray, tree), cfg)
    carried = convert.opt_state_from_jax(state_ref, cfg, device="cpu")
    assert int(state.step) == int(state_ref.step) == int(carried.step)
    assert state.step.dtype == torch.int32 and (carried.err is None) == (state.err is None)
    for name, want in flat(params_ref).items():
        _close(dict(model.named_parameters())[name], want, TOL_STATE)
    tol = {"master": TOL_STATE, "mu": TOL_STATE + delta, "nu": TOL_STATE + 2 * delta,
           "err": TOL_STATE}
    for field in ("master", "mu", "nu") + (("err",) if state.err is not None else ()):
        want = getattr(carried, field)
        got = getattr(state, field)
        assert list(got) == list(want)
        for name in want:
            _close(got[name], want[name], tol[field], (field, name))


@pytest.mark.parametrize("clip_norm,compress", [(1.0, False), (1e6, False), (1.0, True)],
                         ids=["clipped", "unclipped", "compressed"])
def test_apply_updates_on_the_reference_gradients(ref_grads, clip_norm, compress):
    params_ref, grads = ref_grads
    cfg = base.get_config(ARCH, smoke=True)
    opt = O.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10, clip_norm=clip_norm,
                        compress_grads=compress)
    ref_opt = RO.AdamWConfig(**dataclasses.asdict(opt))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    state = O.init_opt_state(steps.trainable(model), opt)
    state_ref = RO.init_opt_state(params_ref, ref_opt)
    _check_state(model, state, params_ref, state_ref, cfg)
    assert all(w.data_ptr() != p.data_ptr()
               for w, p in zip(state.master.values(), model.parameters()))
    # with compression, one scale per array of the reference's tree: the
    # layers it stacks share one
    groups = transformer.stacked_groups(list(state.master), cfg)
    assert len(groups) == len(jax.tree.leaves(params_ref))
    p_ref, delta = params_ref, 0.0
    for g in grads:
        stats = O.apply_updates(steps.trainable(model),
                                convert.tensors_from_jax(jax.tree.map(np.asarray, g), cfg,
                                                         device="cpu"), state, opt, groups=groups)
        p_ref, state_ref, stats_ref = RO.apply_updates(p_ref, g, state_ref, ref_opt)
        gn, gn_ref = float(stats["grad_norm"]), float(stats_ref["grad_norm"])
        assert abs(gn - gn_ref) <= 1e-6 * gn_ref
        if gn_ref > clip_norm:
            delta = max(delta, abs(gn - gn_ref) / gn_ref)
        _check_state(model, state, p_ref, state_ref, cfg, delta)
        assert abs(float(stats["lr"]) - float(stats_ref["lr"])) <= TOL_LR * opt.lr_peak
        # the clip is active exactly when the norm passes clip_norm
        assert (float(stats["grad_norm"]) > clip_norm) == (clip_norm == 1.0)


def test_apply_updates_casts_bf16_params_from_the_f32_master(ref_grads):
    """bf16 parameters are the f32 master rounded to bf16 (to nearest even, as
    jax's astype), and the gradients may come in bf16."""
    params_ref, grads = ref_grads
    cfg = dataclasses.replace(base.get_config(ARCH, smoke=True), param_dtype="bfloat16")
    opt = O.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params_ref), cfg, device="cpu")
    state = O.init_opt_state(steps.trainable(model), opt)
    for g in grads:
        bf = {n: t.to(torch.bfloat16) for n, t in convert.tensors_from_jax(
            jax.tree.map(np.asarray, g), cfg, device="cpu").items()}
        O.apply_updates(steps.trainable(model), bf, state, opt)
    for name, p in model.named_parameters():
        if p.dtype == torch.bfloat16:
            assert torch.equal(p, state.master[name].to(torch.bfloat16)), name
        assert state.master[name].dtype == torch.float32
