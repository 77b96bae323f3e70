"""repro_torch folds, metrics, LDA, ridge regression and the permutation
test on the CPU, against the reference package on the same inputs.

Folds and metrics are exactly equal; f64 decision values agree to ≤ 1e-9
relative; permutation observed values, nulls and p-values are equal when
both packages get the same permutations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro.core import lda as ref_lda
from repro.core import metrics as ref_metrics
from repro.core import permutation as ref_permutation
from repro.core import regression as ref_regression
from repro_torch.core import fastcv, folds, lda, metrics, permutation, regression

TOL = 1e-9


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _problem(n=50, p=200, k=5, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    x = rng.normal(size=(n, p)) + 0.6 * y[:, None] * (np.arange(p) < 8)
    return x, y, ref_folds.kfold(n, k, seed=seed), folds.kfold(n, k, seed=seed, device="cpu")


# --------------------------------------------------------------- folds ----

def _same(tf, rf):
    assert tf.te_idx.dtype == torch.int32 and tf.tr_idx.dtype == torch.int32
    np.testing.assert_array_equal(tf.te_idx.numpy(), np.asarray(rf.te_idx))
    np.testing.assert_array_equal(tf.tr_idx.numpy(), np.asarray(rf.tr_idx))
    assert (tf.n, tf.k, tf.test_size, tf.train_size) == (rf.n, rf.k, rf.test_size,
                                                         rf.train_size)


@pytest.mark.parametrize("n,k,seed,shuffle", [(50, 5, 0, True), (53, 7, 3, True),
                                              (20, 4, 1, False), (787, 10, 0, True)])
def test_kfold_equals_reference(n, k, seed, shuffle):
    _same(folds.kfold(n, k, seed=seed, shuffle=shuffle, device="cpu"),
          ref_folds.kfold(n, k, seed=seed, shuffle=shuffle))


def test_loo_stratified_repeated_equal_reference():
    _same(folds.loo(17, device="cpu"), ref_folds.loo(17))
    labels = np.array([0, 1, 2] * 11 + [0, 1])
    _same(folds.stratified_kfold(labels, 4, seed=2, device="cpu"),
          ref_folds.stratified_kfold(labels, 4, seed=2))
    _same(folds.stratified_kfold(torch.tensor(labels), 4, seed=2, device="cpu"),
          ref_folds.stratified_kfold(labels, 4, seed=2))
    for tf, rf in zip(folds.repeated_kfold(30, 3, 3, seed=5, device="cpu"),
                      ref_folds.repeated_kfold(30, 3, 3, seed=5)):
        _same(tf, rf)
    with pytest.raises(ValueError, match="2 <= k <= n"):
        folds.kfold(5, 6, device="cpu")


def test_with_indices_defaults_n():
    f = folds.Folds.with_indices(torch.zeros(3, 2, dtype=torch.int32),
                                 torch.zeros(3, 4, dtype=torch.int32))
    assert f.n == 6


@pytest.mark.parametrize("make", [
    lambda: folds.kfold(10, 2),
    lambda: folds.loo(4),
    lambda: folds.stratified_kfold([0, 1, 0, 1], 2),
    lambda: permutation.permutation_indices(0, 5, 2),
], ids=["kfold", "loo", "stratified", "permutation_indices"])
def test_device_none_without_cuda_raises(make, monkeypatch):
    """``device=None`` means the card; without one it raises, never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


# ------------------------------------------------------------- metrics ----

def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    d = np.round(rng.normal(size=40), 1)            # ties exercise mid-ranks
    y = np.where(rng.random(40) > 0.4, 1.0, -1.0)
    for port, ref in ((metrics.binary_accuracy, ref_metrics.binary_accuracy),
                      (metrics.auc, ref_metrics.auc)):
        got = port(torch.tensor(d), torch.tensor(y))
        want = ref(jnp.asarray(d), jnp.asarray(y))
        assert float(got) == float(want) and str(got.dtype).endswith(str(want.dtype))
    # sums over other orders: equal to f64 rounding
    for port, ref in ((metrics.mse, ref_metrics.mse), (metrics.r2, ref_metrics.r2)):
        _close(port(torch.tensor(d), torch.tensor(y)), ref(jnp.asarray(d), jnp.asarray(y)))
    dd = d.reshape(5, 8)
    yy = y.reshape(5, 8)
    rows = metrics.auc_rows(torch.tensor(dd), torch.tensor(yy)).numpy()
    np.testing.assert_array_equal(rows, [float(ref_metrics.auc(jnp.asarray(a), jnp.asarray(b)))
                                         for a, b in zip(dd, yy)])
    pred = rng.integers(0, 3, size=30)
    true = rng.integers(0, 3, size=30)
    np.testing.assert_array_equal(
        metrics.confusion_matrix(torch.tensor(pred), torch.tensor(true), 3).numpy(),
        np.asarray(ref_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), 3)))
    got = metrics.multiclass_accuracy(torch.tensor(pred), torch.tensor(true))
    want = ref_metrics.multiclass_accuracy(jnp.asarray(pred), jnp.asarray(true))
    assert got.dtype == torch.float32 and float(got) == float(want)


@pytest.mark.parametrize("n", [91, 120, 192, 780, 787, 49920])
def test_multiclass_accuracy_bitwise_equals_reference(n):
    """The share of hits rounds as the reference's mean (count × f32(1/n)),
    bit for bit, over a sweep of hit counts (780 = K·m at N = 787, K = 10)."""
    hits_counts = np.unique(np.linspace(0, n, num=min(n + 1, 97)).astype(int))
    true = np.zeros(n, dtype=np.int32)
    for hits in hits_counts:
        pred = np.where(np.arange(n) < hits, 0, 1).astype(np.int32)
        got = metrics.multiclass_accuracy(torch.tensor(pred), torch.tensor(true))
        want = np.asarray(ref_metrics.multiclass_accuracy(jnp.asarray(pred), jnp.asarray(true)))
        assert got.numpy().tobytes() == want.tobytes(), (n, hits)


# ------------------------------------------------------------ baselines ----

@pytest.mark.parametrize("form", ["lda", "regression"])
def test_standard_cv_binary_matches_reference(form):
    x, y, rf, tf = _problem(n=40, p=30, k=4, seed=1)
    dv_r, yte_r = ref_lda.standard_cv_binary(jnp.asarray(x), jnp.asarray(y), rf, 2.0, form=form)
    dv_t, yte_t = lda.standard_cv_binary(torch.tensor(x), torch.tensor(y), tf, 2.0, form=form)
    _close(dv_t, dv_r)
    np.testing.assert_array_equal(yte_t.numpy(), np.asarray(yte_r))


@pytest.mark.parametrize("n,p,k,lam", [(40, 120, 5, 3.0), (60, 20, 6, 0.5), (24, 300, 24, 10.0)])
def test_analytical_equals_retrain_in_the_port(n, p, k, lam):
    """The paper's exactness claim, inside the port: analytical dvals equal
    the retrained regression-form fits (dual and primal, k-fold and LOO)."""
    x, y, _, _ = _problem(n, p, seed=n)
    tf = folds.kfold(n, k, seed=1, device="cpu") if k < n else folds.loo(n, device="cpu")
    xt, yt = torch.tensor(x), torch.tensor(y)
    for fused in (False, True):
        plan = fastcv.prepare(xt, tf, lam, with_train_block=False)
        got = fastcv.binary_dvals(plan, yt, adjust_bias=False, fused=fused)
        want, _ = lda.standard_cv_binary(xt, yt, tf, lam, form="regression")
        _close(got, want, 1e-8)


def test_ridge_regression_matches_reference():
    rng = np.random.default_rng(11)
    for n, p in ((40, 120), (60, 20)):
        x = rng.normal(size=(n, p))
        y = x[:, :3].sum(1) + 0.1 * rng.normal(size=n)
        rf, tf = ref_folds.kfold(n, 5, seed=2), folds.kfold(n, 5, seed=2, device="cpu")
        for port, ref in ((regression.analytical_cv, ref_regression.analytical_cv),
                          (regression.standard_cv, ref_regression.standard_cv)):
            got, yte = port(torch.tensor(x), torch.tensor(y), tf, 2.0)
            want, yte_r = ref(jnp.asarray(x), jnp.asarray(y), rf, 2.0)
            _close(got, want)
            np.testing.assert_array_equal(yte.numpy(), np.asarray(yte_r))
        w, b = regression.fit_ridge(torch.tensor(x), torch.tensor(y), 2.0)
        wr, br = ref_regression.fit_ridge(jnp.asarray(x), jnp.asarray(y), 2.0)
        _close(w, wr)
        _close(b, br)
        # the analytical route equals the retrain route inside the port
        _close(regression.analytical_cv(torch.tensor(x), torch.tensor(y), tf, 2.0)[0],
               regression.standard_cv(torch.tensor(x), torch.tensor(y), tf, 2.0)[0], 1e-8)
    with pytest.raises(ValueError, match="lam > 0"):
        regression.fit_ridge(torch.tensor(x[:5]), torch.tensor(y[:5]), 0.0)


def test_ridge_analytical_cv_kernel_route_on_cpu():
    """fused=True on the CPU runs fold_eval's plain version: same predictions."""
    x, y, _, tf = _problem(seed=3)
    plan = fastcv.prepare(torch.tensor(x), tf, 2.0, with_train_block=False)
    a = fastcv.cv_errors(plan, torch.tensor(y), fused=True)[0]
    b = regression.analytical_cv(torch.tensor(x), torch.tensor(y), tf, 2.0)[0]
    _close(a, b)


# --------------------------------------------------------- permutation ----

def test_permutation_indices_prefix_stable_and_valid():
    a = permutation.permutation_indices(7, 30, 12, device="cpu")
    b = permutation.permutation_indices(7, 30, 5, device="cpu")
    assert a.shape == (12, 30)
    assert torch.equal(a[:5], b)
    assert torch.equal(a.sort(dim=1).values, torch.arange(30).expand(12, 30))
    assert not torch.equal(a, permutation.permutation_indices(8, 30, 12, device="cpu"))
    assert len({tuple(r) for r in a.tolist()}) == 12
    assert permutation.permutation_indices(7, 30, 0, device="cpu").shape == (0, 30)


@pytest.mark.parametrize("metric", ["accuracy", "auc"])
@pytest.mark.parametrize("adjust_bias", [True, False])
def test_analytical_permutation_matches_reference(metric, adjust_bias, monkeypatch):
    """Observed value, null and p-value equal the reference's when both
    packages get the reference's permutations."""
    x, y, rf, tf = _problem(n=40, p=120, k=4, seed=6)
    key = jax.random.PRNGKey(3)
    n_perm = 11
    perms = np.asarray(ref_permutation.permutation_indices(key, len(y), n_perm))
    monkeypatch.setattr(permutation, "permutation_indices",
                        lambda seed, n, t, device=None: torch.tensor(perms[:t]))
    want = ref_permutation.analytical_permutation_binary(
        jnp.asarray(x), jnp.asarray(y), rf, 2.0, n_perm, key, metric=metric, chunk=4,
        adjust_bias=adjust_bias)
    got = permutation.analytical_permutation_binary(
        torch.tensor(x), torch.tensor(y), tf, 2.0, n_perm, 0, metric=metric, chunk=4,
        adjust_bias=adjust_bias)
    assert float(got.observed) == float(want.observed)
    np.testing.assert_array_equal(got.null.numpy(), np.asarray(want.null))
    assert float(got.p) == float(want.p)


def test_standard_permutation_matches_reference(monkeypatch):
    x, y, rf, tf = _problem(n=24, p=10, k=3, seed=8)
    key = jax.random.PRNGKey(1)
    perms = np.asarray(ref_permutation.permutation_indices(key, len(y), 4))
    monkeypatch.setattr(permutation, "permutation_indices",
                        lambda seed, n, t, device=None: torch.tensor(perms[:t]))
    want = ref_permutation.standard_permutation_binary(jnp.asarray(x), jnp.asarray(y), rf, 1.0,
                                                       4, key)
    got = permutation.standard_permutation_binary(torch.tensor(x), torch.tensor(y), tf, 1.0, 4, 0)
    assert float(got.observed) == float(want.observed)
    np.testing.assert_array_equal(got.null.numpy(), np.asarray(want.null))
    assert float(got.p) == float(want.p)


def test_p_value_equals_reference():
    null = np.array([0.4, 0.5, 0.6, 0.7, 0.5])
    for obs in (0.5, 0.65, 0.9):
        assert float(permutation.p_value(torch.tensor(obs), torch.tensor(null))) == float(
            ref_permutation.p_value(jnp.asarray(obs), jnp.asarray(null)))


def test_permutation_test_end_to_end_in_the_port():
    """Own generator: a strong effect gives the smallest p-value."""
    x, y, _, tf = _problem(n=40, p=120, k=4, seed=12)
    x = x + 2.0 * y[:, None] * (np.arange(120) < 8)
    res = permutation.analytical_permutation_binary(torch.tensor(x), torch.tensor(y), tf, 2.0,
                                                    20, 5, chunk=8)
    assert res.null.shape == (20,)
    assert float(res.observed) > 0.9
    assert float(res.p) == pytest.approx(1.0 / 21)
    with pytest.raises(ValueError, match="metric"):
        permutation._fold_metric_binary(torch.zeros(2, 3), torch.ones(2, 3), "f1")


def test_fastcv_dvals_used_by_permutation_equal_reference_plan():
    """The permutation test's plan is the same plan fastcv.prepare builds."""
    x, y, rf, tf = _problem(n=30, p=90, k=3, seed=2)
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, 2.0)
    tp = fastcv.prepare(torch.tensor(x), tf, 2.0)
    _close(tp.h, rp.h)
