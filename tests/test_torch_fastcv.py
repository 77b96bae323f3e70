"""repro_torch.core.fastcv on the CPU against the reference package.

The same numpy inputs go through both packages. f64 results agree to
≤ 1e-9 relative to their largest magnitude; fold indices, plan keys and
fingerprints are exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro_torch.core import fastcv, folds

TOL = 1e-9


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _problem(n=48, p=150, k=6, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) + shift
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    x[y > 0, :5] += 0.8
    return x, y, ref_folds.kfold(n, k, seed=seed), folds.kfold(n, k, seed=seed, device="cpu")


@pytest.mark.parametrize("n,p,lam", [(40, 120, 3.0), (60, 20, 0.5), (60, 20, 0.0)])
def test_hat_matrices_match_reference(n, p, lam):
    x = np.random.default_rng(n + p).normal(size=(n, p))
    if lam == 0.0:
        got, want = fastcv.hat_matrix_primal(torch.tensor(x)), ref_fastcv.hat_matrix_primal(
            jnp.asarray(x))
    else:
        got = fastcv.hat_matrix(torch.tensor(x), lam)
        want = ref_fastcv.hat_matrix(jnp.asarray(x), lam)
    _close(got, want)


def test_hat_matrix_dual_rejects_zero_lambda():
    with pytest.raises(ValueError, match="lam > 0"):
        fastcv.hat_matrix(torch.zeros(4, 10), 0.0)


@pytest.mark.parametrize("with_train_block", [True, False])
@pytest.mark.parametrize("n,p", [(48, 150), (60, 20)])
def test_prepare_leaves_match_reference(n, p, with_train_block):
    x, _, rf, tf = _problem(n, p)
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, 2.0, with_train_block=with_train_block)
    tp = fastcv.prepare(torch.tensor(x), tf, 2.0, with_train_block=with_train_block)
    for name in ("h", "chol_ih") + (("h_tr_te",) if with_train_block else ()):
        _close(getattr(tp, name), getattr(rp, name))
    assert torch.equal(tp.te_idx, tf.te_idx) and tp.te_idx.dtype == torch.int32
    assert tp.h.is_contiguous()          # the kernels read H as a row-major buffer
    assert (tp.h_tr_te is None) == (not with_train_block)
    assert tp.nbytes == rp.nbytes and tp.k == rp.k


def test_prepare_with_precomputed_gram_and_bf16():
    x, _, rf, tf = _problem()
    xt = torch.tensor(x)
    g = fastcv.prepare(xt, tf, 2.0, gram=(xt - xt.mean(0)) @ (xt - xt.mean(0)).T)
    _close(g.h, fastcv.prepare(xt, tf, 2.0).h)
    x32 = x.astype(np.float32)
    got = fastcv.prepare(torch.tensor(x32), tf, 2.0, precision="bf16_gram").h
    want = ref_fastcv.prepare(jnp.asarray(x32), rf, 2.0, precision="bf16_gram").h
    _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="dual-mode"):
        fastcv.prepare(torch.tensor(x[:, :10]), tf, 2.0, precision="bf16_gram")
    with pytest.raises(ValueError, match="dual mode"):
        fastcv.prepare(torch.tensor(x[:, :10]), tf, 2.0, gram=torch.eye(48))


@pytest.mark.parametrize("with_train_block", [True, False])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("batch", [None, 5])
def test_cv_errors_both_routes_match_reference(with_train_block, fused, batch):
    x, y, rf, tf = _problem()
    yy = y if batch is None else np.random.default_rng(3).normal(size=(len(y), batch))
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, 2.0, with_train_block=with_train_block)
    tp = fastcv.prepare(torch.tensor(x), tf, 2.0, with_train_block=with_train_block)
    want = ref_fastcv.cv_errors(rp, jnp.asarray(yy), fused=fused)
    got = fastcv.cv_errors(tp, torch.tensor(yy), fused=fused)
    _close(got[0], want[0])
    if with_train_block:
        _close(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


def test_cv_errors_default_route_on_cpu_is_the_composite():
    x, y, _, tf = _problem()
    tp = fastcv.prepare(torch.tensor(x), tf, 2.0)
    default = fastcv.cv_errors(tp, torch.tensor(y))
    composite = fastcv.cv_errors(tp, torch.tensor(y), fused=False)
    assert torch.equal(default[0], composite[0]) and torch.equal(default[1], composite[1])


def test_kernel_route_copies_labels_that_start_unaligned(monkeypatch):
    """A row of a (T, N) f32 label tensor at N = 787 starts 3,148 bytes into
    its storage (12 mod 16). hat_apply's f32 kernel copies Y in aligned
    16-byte pieces, so the kernel route hands hat_errors a fresh copy; the
    errors equal the composite route's."""
    n, t = 787, 3
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, 40)).astype(np.float32)
    ys = torch.tensor(np.where(rng.random((t, n)) < 0.5, 1.0, -1.0).astype(np.float32))
    plan = fastcv.prepare(torch.tensor(x), folds.kfold(n, 10, device="cpu"), 2.0)
    assert ys[1].data_ptr() % 16 == (n * 4) % 16 == 12
    seen = []
    hat_errors = fastcv.hat_errors

    def recording(h, y):
        seen.append(y.data_ptr() % 16)
        return hat_errors(h, y)

    monkeypatch.setattr(fastcv, "hat_errors", recording)
    got = fastcv.cv_errors(plan, ys[1], fused=True)
    want = fastcv.cv_errors(plan, ys[1], fused=False)
    assert seen == [0]
    _close(got[0], want[0], 1e-5)   # the f32 kernels' pin; measured ~1e-6
    _close(got[1], want[1], 1e-5)


@pytest.mark.parametrize("adjust_bias", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_binary_dvals_match_reference(adjust_bias, fused):
    x, y, rf, tf = _problem(seed=4)
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, 1.5, with_train_block=adjust_bias)
    tp = fastcv.prepare(torch.tensor(x), tf, 1.5, with_train_block=adjust_bias)
    perms = np.stack([np.random.default_rng(i).permutation(y) for i in range(4)], axis=1)
    for labels in (y, perms):
        want = ref_fastcv.binary_dvals(rp, jnp.asarray(labels), adjust_bias=adjust_bias,
                                       fused=fused)
        got = fastcv.binary_dvals(tp, torch.tensor(labels), adjust_bias=adjust_bias,
                                  fused=fused)
        _close(got, want)


def test_binary_dvals_adjust_needs_train_block():
    x, y, _, tf = _problem()
    tp = fastcv.prepare(torch.tensor(x), tf, 1.0, with_train_block=False)
    with pytest.raises(ValueError, match="with_train_block"):
        fastcv.binary_dvals(tp, torch.tensor(y))


@pytest.mark.parametrize("adjust_bias", [True, False])
def test_binary_cv_matches_reference(adjust_bias):
    x, y, rf, tf = _problem(n=50, p=200, k=5, seed=9, shift=3.0)
    dv_r, yte_r = ref_fastcv.binary_cv(jnp.asarray(x), jnp.asarray(y), rf, 4.0,
                                       adjust_bias=adjust_bias)
    dv_t, yte_t = fastcv.binary_cv(torch.tensor(x), torch.tensor(y), tf, 4.0,
                                   adjust_bias=adjust_bias)
    _close(dv_t, dv_r)
    np.testing.assert_array_equal(yte_t.numpy(), np.asarray(yte_r))


def test_eval_factories_match_reference():
    x, y, rf, tf = _problem()
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, 2.0)
    tp = fastcv.prepare(torch.tensor(x), tf, 2.0)
    yb = np.stack([y, -y], axis=1)
    _close(fastcv.make_eval_binary()(tp, torch.tensor(yb)),
           ref_fastcv.make_eval_binary()(rp, jnp.asarray(yb)))
    _close(fastcv.make_eval_cv(fused=True)(tp, torch.tensor(yb)),
           ref_fastcv.make_eval_cv(fused=True)(rp, jnp.asarray(yb)))


# ----------------------------------------------- keys, fingerprints, plans ----

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fingerprint_and_plan_key_equal_reference(dtype):
    x, _, rf, tf = _problem()
    x = x.astype(dtype)
    assert fastcv.fingerprint(torch.tensor(x)) == ref_fastcv.fingerprint(jnp.asarray(x))
    for prec in (None, "bf16_gram"):
        for wtb in (True, False):
            got = fastcv.plan_key(torch.tensor(x), tf, 2.0, with_train_block=wtb,
                                  version=3, precision=prec)
            want = ref_fastcv.plan_key(jnp.asarray(x), rf, 2.0, with_train_block=wtb,
                                       version=3, precision=prec)
            assert got == want


def test_fingerprint_above_sample_cap_equals_reference():
    """Above the cap the digest takes a strided sample and an f64 checksum,
    on the host, exactly as the reference does."""
    x = np.random.default_rng(5).normal(size=(37, 53)).astype(np.float32)
    for cap in (16, 100, 1 << 20):
        got = fastcv.fingerprint(torch.tensor(x), sample_cap=cap)
        assert got == ref_fastcv.fingerprint(jnp.asarray(x), sample_cap=cap)
    assert fastcv.fingerprint(torch.tensor(x), sample_cap=16) != fastcv.fingerprint(
        torch.tensor(x))


def test_fingerprint_follows_in_place_mutation():
    """Tensors are mutable: a digest must never be served stale."""
    t = torch.zeros(4, 4)
    before = fastcv.fingerprint(t)
    t[0, 0] = 1.0
    assert fastcv.fingerprint(t) != before


def test_plan_from_reference_arrays_serves_the_same_predictions():
    x, y, rf, tf = _problem(seed=2)
    for wtb in (True, False):
        rp = ref_fastcv.prepare(jnp.asarray(x), rf, 2.0, with_train_block=wtb)
        arrays = ref_fastcv.plan_to_arrays(rp)
        tp = fastcv.plan_from_arrays(arrays, device="cpu")
        for name, leaf in fastcv.plan_to_arrays(tp).items():
            np.testing.assert_array_equal(leaf, arrays[name])
            assert leaf.dtype == arrays[name].dtype
        assert set(fastcv.plan_to_arrays(tp)) == set(arrays)
        _close(fastcv.binary_dvals(tp, torch.tensor(y), adjust_bias=wtb),
               ref_fastcv.binary_dvals(rp, jnp.asarray(y), adjust_bias=wtb))
    with pytest.raises(ValueError, match="missing"):
        fastcv.plan_from_arrays({"h": arrays["h"]}, device="cpu")


def test_plan_from_arrays_default_device_needs_cuda(monkeypatch):
    x, _, rf, _ = _problem()
    arrays = ref_fastcv.plan_to_arrays(ref_fastcv.prepare(jnp.asarray(x), rf, 2.0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fastcv.plan_from_arrays(arrays)
