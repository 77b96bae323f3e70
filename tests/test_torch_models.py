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


# The draw's yardstick: Philox4x32-10 and the Fisher–Yates shuffle with
# Lemire's rejection, one scalar at a time in plain Python integers.
_M32 = 0xFFFFFFFF


def _philox_scalar(key, ctr):
    (c0, c1, c2, c3), (k0, k1) = ctr, key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & _M32, (p0 >> 32) ^ c3 ^ k1, p0 & _M32
    return c0, c1, c2, c3


def _scalar_word(key, row, w):
    return _philox_scalar(key, (w >> 2, row & _M32, row >> 32, 0))[w & 3]


def _scalar_rows(key, t, n, word=_scalar_word):
    rows = []
    for r in range(t):
        a, w = list(range(n)), 0
        for i in range(n - 1, 0, -1):
            s = i + 1
            m = word(key, r, w) * s
            w += 1
            while (m & _M32) < (1 << 32) % s:
                m = word(key, r, w) * s
                w += 1
            a[i], a[m >> 32] = a[m >> 32], a[i]
        rows.append(a)
    return rows


def _key(seed):
    return tuple(int(k) for k in np.random.SeedSequence([seed]).generate_state(2, np.uint32))


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_M32,) * 4, (_M32, _M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ((7, 123456, 1, 0), _key(2026), None),
    ((0xFFFFFFFE, 0x80000001, 0, 0xDEADBEEF), _key(2 ** 70), None),
], ids=["kat-zero", "kat-ones", "kat-pi", "seeded", "wide"])
def test_permdraw_philox_equals_scalar_rounds(ctr, key, want):
    """The plain version's vectorised Philox4x32-10 (16-bit split products in
    int64) equals the scalar rounds, and both equal Random123's known
    answers where given."""
    from repro_torch.kernels.permdraw.ref import philox4x32_10

    got = tuple(int(v) for v in philox4x32_10(key, *(torch.tensor([c]) for c in ctr)))
    assert got == _philox_scalar(key, ctr)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("seed,t,n", [(0, 6, 13), (11, 40, 2), (2 ** 63 + 9, 5, 64)])
def test_permutation_indices_equal_the_scalar_shuffle(seed, t, n):
    """Rows on the CPU are the scalar Fisher–Yates over the scalar words
    under the key SeedSequence([seed]) gives."""
    got = permutation.permutation_indices(seed, n, t, device="cpu")
    assert got.dtype == torch.int64
    assert got.tolist() == _scalar_rows(_key(seed), t, n)


def test_permdraw_rejection_takes_the_next_word(monkeypatch):
    """A rejected draw (a zero word is rejected for every s that is not a
    power of two) takes the next word of its own row, as the scalar shuffle
    does; other rows are untouched."""
    from repro_torch.kernels.permdraw import ref

    planted = {(1, 0), (2, 3), (2, 4), (4, 11)}          # (row, word index) read as 0

    def word(key, r, w):
        return 0 if (r, w) in planted else _scalar_word(key, r, w)

    words = ref._words

    def planted_words(key, rows, first, blocks):
        out = words(key, rows, first, blocks)
        for r, w in planted:
            if 4 * first <= w < 4 * (first + blocks):
                out[r, w - 4 * first] = 0
        return out

    monkeypatch.setattr(ref, "_words", planted_words)
    key = _key(5)
    got = ref.permdraw_ref(key, 6, 13, device="cpu")
    assert got.tolist() == _scalar_rows(key, 6, 13, word)
    assert got.tolist() != _scalar_rows(key, 6, 13)
    assert got[[0, 3, 5]].tolist() == [_scalar_rows(key, 6, 13)[r] for r in (0, 3, 5)]


@pytest.mark.parametrize("t,n", [(3, 0), (3, 1), (4, 2), (0, 5), (0, 0)])
def test_permutation_indices_edge_shapes(t, n):
    got = permutation.permutation_indices(3, n, t, device="cpu")
    assert got.shape == (t, n) and got.dtype == torch.int64
    assert torch.equal(got.sort(dim=1).values, torch.arange(n).expand(t, n))


@pytest.mark.parametrize("key,t,n", [((1, 2), -1, 5), ((1, 2), 4, 2 ** 31), ((1, 2, 3), 4, 5),
                                     ((1, 2 ** 32), 4, 5), ((-1, 2), 4, 5)])
def test_permdraw_refuses_what_it_does_not_take(key, t, n):
    from repro_torch.kernels.permdraw.ops import permdraw

    with pytest.raises(ValueError):
        permdraw(key, t, n, device="cpu")


def test_permutation_indices_accept_seeds_above_2_63():
    big = permutation.permutation_indices(2 ** 64 + 5, 30, 8, device="cpu")
    assert torch.equal(big.sort(dim=1).values, torch.arange(30).expand(8, 30))
    assert not torch.equal(big, permutation.permutation_indices(5, 30, 8, device="cpu"))
    assert torch.equal(big, permutation.permutation_indices(2 ** 64 + 5, 30, 8, device="cpu"))


def test_permutation_indices_refuse_a_negative_seed():
    with pytest.raises(ValueError):
        permutation.permutation_indices(-1, 30, 8, device="cpu")


def test_permutation_indices_are_uniform_over_all_24_orders():
    """Pearson's chi-square of the 24 permutations of N = 4 over 24,000 rows
    (23 degrees of freedom) under 49.73, its upper 0.1 % point."""
    rows = permutation.permutation_indices(0, 4, 24_000, device="cpu")
    codes = ((rows[:, 0] * 4 + rows[:, 1]) * 4 + rows[:, 2]) * 4 + rows[:, 3]
    counts = torch.bincount(codes, minlength=256)
    counts = counts[counts > 0].double()
    assert counts.numel() == 24
    chi2 = float(((counts - 1000.0) ** 2 / 1000.0).sum())
    assert chi2 < 49.73, chi2


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
