"""repro_torch multi-class LDA (Algorithm 2) and its permutation test on the
CPU, against the reference package on the same numpy inputs.

Plans are built by the reference and carried over with
``fastcv.plan_from_arrays(reference plan_to_arrays)``. Tolerances: step-1
fits ≤ 1e-9 relative at f64; optimal-scoring weights equal up to per-column
sign (|cos| ≥ 1 − 1e-8) with α² within 1e-9; predictions equal wherever the
centroid-distance margin exceeds 1e-8 of the distances' scale (argmin
near-ties may fall either way); permutation observed values, nulls and
p-values exactly equal when both packages get the same permutations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro.core import multiclass as ref_multiclass
from repro.core import permutation as ref_permutation
from repro_torch.core import fastcv, folds, metrics, multiclass, permutation

TOL = 1e-9
MARGIN_TOL = 1e-8


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _problem(n, p, c, seed=0, sep=1.5, stratified=False, k=5):
    """Labels cycle through the classes; class means differ along random
    directions. Returns numpy (x, y) and the folds of both packages."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % c).astype(np.int32)
    means = sep * rng.normal(size=(c, p)) / np.sqrt(p) * 3.0
    x = rng.normal(size=(n, p)) + means[y]
    if stratified:
        rf = ref_folds.stratified_kfold(y, k, seed=seed)
        tf = folds.stratified_kfold(y, k, seed=seed, device="cpu")
    else:
        rf, tf = ref_folds.kfold(n, k, seed=seed), folds.kfold(n, k, seed=seed, device="cpu")
    return x, y, rf, tf


def _plans(x, rf, lam, with_train_block=True):
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, lam, with_train_block=with_train_block)
    return rp, fastcv.plan_from_arrays(ref_fastcv.plan_to_arrays(rp), device="cpu")


def _decisive(d2):
    """Bool mask of the predictions whose argmin is not a near-tie: the gap
    between the two smallest centroid distances exceeds MARGIN_TOL × scale."""
    d2 = np.asarray(d2)
    s = np.sort(d2, axis=-1)
    return (s[..., 1] - s[..., 0]) > MARGIN_TOL * np.max(np.abs(d2), axis=-1)


def _equal_where_decisive(got, want, d2):
    mask = _decisive(d2)
    assert mask.mean() > 0.9, "nearly every prediction is a near-tie (vacuous)"
    np.testing.assert_array_equal(np.asarray(got)[mask], np.asarray(want)[mask])


# ------------------------------------------------------------------ onehot ----

def test_onehot_equals_reference_including_out_of_range():
    y = np.array([0, 2, 1, 3, -1, 2], dtype=np.int32)
    got = multiclass.onehot(torch.tensor(y), 3)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(y), 3, dtype=jnp.float64))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert multiclass.onehot(torch.tensor(y), 3, dtype=torch.float32).dtype == torch.float32


# ------------------------------------------------------------------ step 1 ----

@pytest.mark.parametrize("n,p,c,k,lam", [(60, 10, 3, 5, 0.5), (90, 30, 5, 6, 1.0),
                                         (40, 120, 4, 5, 2.0)])
@pytest.mark.parametrize("fused", [False, True])
def test_step1_fits_equal_reference(n, p, c, k, lam, fused):
    x, y, rf, _ = _problem(n, p, c, seed=n, k=k)
    rp, tp = _plans(x, rf, lam)
    y1h = multiclass.onehot(torch.tensor(y), c)
    te, tr = fastcv.cv_errors(tp, y1h, fused=fused)
    te_r, tr_r = ref_fastcv.cv_errors(rp, ref_multiclass.onehot(jnp.asarray(y), c))
    _close(te, te_r)
    _close(tr, tr_r)


# ------------------------------------------------------- optimal scoring ----

@pytest.mark.parametrize("balanced", [True, False])
def test_optimal_scoring_equals_reference_and_direct_lda(balanced):
    n, p, c, lam = 120, 15, 4, 0.8
    x, y, _, _ = _problem(n, p, c, seed=2)
    if not balanced:
        y = np.where((np.arange(n) % 9 == 0) & (y == 0), 1, y).astype(np.int32)
    y1h = multiclass.onehot(torch.tensor(y), c)
    w_os, a2 = multiclass.optimal_scoring_fit(torch.tensor(x), y1h, lam)
    w_ref, a2_ref = ref_multiclass.optimal_scoring_fit(
        jnp.asarray(x), ref_multiclass.onehot(jnp.asarray(y), c), lam)
    model = multiclass.fit_multiclass(torch.tensor(x), y1h, lam)
    assert w_os.shape == (p, c - 1) and a2.shape == (c - 1,)
    assert float(np.max(np.abs(a2.numpy() - np.asarray(a2_ref)))) <= TOL
    w_ref = np.asarray(w_ref)
    for j in range(c - 1):
        for other in (w_ref[:, j], model.w[:, j].numpy()):
            a = w_os[:, j].numpy()
            cos = abs(a @ other) / (np.linalg.norm(a) * np.linalg.norm(other))
            assert cos >= 1 - 1e-8, (j, cos)
            assert np.linalg.norm(a) / np.linalg.norm(other) == pytest.approx(1.0, rel=1e-6)
    assert np.all(a2.numpy() < 1.0) and np.all(a2.numpy() > 0.0)


def test_direct_lda_predictions_equal_reference():
    n, p, c, lam = 90, 20, 4, 1.0
    x, y, _, _ = _problem(n, p, c, seed=5)
    y1h = multiclass.onehot(torch.tensor(y), c)
    model = multiclass.fit_multiclass(torch.tensor(x), y1h, lam)
    ref = ref_multiclass.fit_multiclass(jnp.asarray(x), ref_multiclass.onehot(jnp.asarray(y), c),
                                        lam)
    got = multiclass.predict_multiclass(torch.tensor(x), model)
    want = ref_multiclass.predict_multiclass(jnp.asarray(x), ref)
    d2 = ((torch.tensor(x) @ model.w)[:, None, :] - model.centroids[None]).pow(2).sum(-1)
    _equal_where_decisive(got.numpy(), want, d2.numpy())
    # the same fit up to per-column sign: the centroids' distances agree
    _close(torch.cdist(model.centroids, model.centroids),
           np.linalg.norm(np.asarray(ref.centroids)[:, None] - np.asarray(ref.centroids)[None],
                          axis=-1), 1e-7)


def test_os_step2_drops_the_trivial_pair_and_clips():
    """M = D_π (α² = 1 for every direction): the kept α² clip to 1 − ε."""
    d_pi = torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64)
    theta_d, a2 = multiclass._os_step2(torch.diag(d_pi), d_pi, 10)
    assert theta_d.shape == (3, 2) and a2.shape == (2,)
    assert torch.equal(a2, torch.full((2,), 1.0 - multiclass._EPS, dtype=torch.float64))
    # batched: leading dimensions broadcast through
    m = torch.stack([torch.diag(d_pi), 0.5 * torch.diag(d_pi)])
    _, a2b = multiclass._os_step2(m, d_pi.expand(2, 3), 10)
    assert a2b.shape == (2, 2)


# --------------------------------------------------------- Algorithm 2 ----

@pytest.mark.parametrize("n,p,c,k,lam", [(100, 20, 5, 5, 0.5), (60, 200, 5, 6, 3.0),
                                         (120, 300, 3, 10, 50.0)])
@pytest.mark.parametrize("fused", [False, True])
def test_analytical_cv_multiclass_equals_reference(n, p, c, k, lam, fused):
    x, y, rf, tf = _problem(n, p, c, seed=4, stratified=True, k=k)
    rp, tp = _plans(x, rf, lam)
    want, y_te_r = ref_multiclass.analytical_cv_multiclass(jnp.asarray(x), jnp.asarray(y), rf,
                                                           c, lam, plan=rp)
    got, y_te = multiclass.analytical_cv_multiclass(torch.tensor(x), torch.tensor(y), tf, c,
                                                    lam, plan=tp, fused=fused)
    np.testing.assert_array_equal(y_te.numpy(), np.asarray(y_te_r))
    d2, _ = multiclass._batch_distances(tp, torch.tensor(y)[None], c, fused=fused)
    _equal_where_decisive(got.numpy(), want, d2[0].numpy())
    # building the plan inside gives the same answers as the carried-over one
    own, _ = multiclass.analytical_cv_multiclass(torch.tensor(x), torch.tensor(y), tf, c, lam,
                                                 fused=fused)
    _equal_where_decisive(own.numpy(), got.numpy(), d2[0].numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_batch_predict_equals_reference(fused):
    n, p, c, lam = 60, 150, 4, 2.0
    x, y, rf, _ = _problem(n, p, c, seed=9)
    rp, tp = _plans(x, rf, lam)
    rng = np.random.default_rng(1)
    batch = np.stack([y] + [rng.permutation(y) for _ in range(5)]).astype(np.int32)
    want = ref_multiclass.batch_predict(rp, jnp.asarray(batch), c)
    want_fused = ref_multiclass.batch_predict(rp, jnp.asarray(batch), c, fused=True)
    got = multiclass.batch_predict(tp, torch.tensor(batch), c, fused=fused)
    assert got.shape == (6, rf.k, rf.test_size)
    d2, a2 = multiclass._batch_distances(tp, torch.tensor(batch), c, fused=fused)
    assert d2.shape == (6, rf.k, rf.test_size, c) and a2.shape == (6, rf.k, c - 1)
    _equal_where_decisive(got.numpy(), want, d2.numpy())
    _equal_where_decisive(got.numpy(), want_fused, d2.numpy())
    evaluator = multiclass.make_eval_multiclass(c, fused=fused)
    assert torch.equal(evaluator(tp, torch.tensor(batch)), got)
    # one label vector of the batch equals analytical_cv_multiclass on it
    single, _ = multiclass.analytical_cv_multiclass(torch.tensor(x), torch.tensor(y), None, c,
                                                    lam, plan=tp, fused=fused)
    assert torch.equal(single, got[0])


@pytest.mark.parametrize("n,p,c,k,lam", [(100, 20, 5, 5, 0.5), (100, 20, 10, 10, 1.0),
                                         (60, 200, 5, 6, 3.0)])
def test_analytical_equals_standard_in_the_port(n, p, c, k, lam):
    """The paper's exactness claim for Algorithm 2, inside the port: the
    analytical predictions equal retraining direct LDA on every fold."""
    x, y, _, tf = _problem(n, p, c, seed=4, stratified=True, k=k)
    fast, y_te = multiclass.analytical_cv_multiclass(torch.tensor(x), torch.tensor(y), tf, c, lam)
    std, y_te_std = multiclass.standard_cv_multiclass(torch.tensor(x), torch.tensor(y), tf, c,
                                                      lam)
    assert torch.equal(y_te, y_te_std)
    assert torch.equal(fast, std)


def test_standard_cv_multiclass_equals_reference():
    n, p, c, lam = 60, 12, 3, 1.0
    x, y, rf, tf = _problem(n, p, c, seed=13)
    want, y_te_r = ref_multiclass.standard_cv_multiclass(jnp.asarray(x), jnp.asarray(y), rf, c,
                                                         lam)
    got, y_te = multiclass.standard_cv_multiclass(torch.tensor(x), torch.tensor(y), tf, c, lam)
    np.testing.assert_array_equal(y_te.numpy(), np.asarray(y_te_r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accuracy_beats_chance_on_separable_data():
    x, y, _, tf = _problem(150, 30, 3, seed=6, sep=4.0, stratified=True)
    pred, y_te = multiclass.analytical_cv_multiclass(torch.tensor(x), torch.tensor(y), tf, 3,
                                                     lam=1.0)
    assert float(metrics.multiclass_accuracy(pred, y_te)) > 0.8


# --------------------------------------------------------- permutation ----

def _use_reference_perms(monkeypatch, key, n, n_perm):
    perms = np.asarray(ref_permutation.permutation_indices(key, n, n_perm))
    monkeypatch.setattr(permutation, "permutation_indices",
                        lambda seed, n, t, device=None: torch.tensor(perms[:t]))


@pytest.mark.parametrize("n_perm,chunk", [(11, 4), (9, 64)])
def test_analytical_permutation_multiclass_equals_reference(n_perm, chunk, monkeypatch):
    """Observed value, null and p-value are exactly the reference's when
    both packages get the reference's permutations."""
    n, p, c, lam = 60, 150, 4, 2.0
    x, y, rf, tf = _problem(n, p, c, seed=21)
    key = jax.random.PRNGKey(3)
    _use_reference_perms(monkeypatch, key, n, n_perm)
    want = ref_permutation.analytical_permutation_multiclass(
        jnp.asarray(x), jnp.asarray(y), rf, c, lam, n_perm, key, chunk=chunk)
    got = permutation.analytical_permutation_multiclass(
        torch.tensor(x), torch.tensor(y), tf, c, lam, n_perm, 0, chunk=chunk)
    assert got.null.dtype == torch.float32 and got.null.shape == (n_perm,)
    assert float(got.observed) == float(want.observed)
    np.testing.assert_array_equal(got.null.numpy(), np.asarray(want.null))
    assert float(got.p) == float(want.p)


def test_standard_permutation_multiclass_equals_reference(monkeypatch):
    n, p, c, lam = 30, 8, 3, 1.0
    x, y, rf, tf = _problem(n, p, c, seed=8, k=3)
    key = jax.random.PRNGKey(1)
    _use_reference_perms(monkeypatch, key, n, 4)
    want = ref_permutation.standard_permutation_multiclass(jnp.asarray(x), jnp.asarray(y), rf,
                                                           c, lam, 4, key)
    got = permutation.standard_permutation_multiclass(torch.tensor(x), torch.tensor(y), tf, c,
                                                      lam, 4, 0)
    assert float(got.observed) == float(want.observed)
    np.testing.assert_array_equal(got.null.numpy(), np.asarray(want.null))
    assert float(got.p) == float(want.p)


def test_multiclass_permutation_end_to_end_in_the_port():
    """Own generator: a strong effect gives the smallest p-value, and the
    analytical null equals the standard one on the same draws."""
    x, y, _, tf = _problem(45, 60, 3, seed=12, sep=5.0, k=3)
    res = permutation.analytical_permutation_multiclass(torch.tensor(x), torch.tensor(y), tf, 3,
                                                        1.0, 12, 5, chunk=5)
    std = permutation.standard_permutation_multiclass(torch.tensor(x), torch.tensor(y), tf, 3,
                                                      1.0, 12, 5)
    assert res.null.shape == (12,)
    assert float(res.observed) > 0.9
    assert float(res.p) == pytest.approx(1.0 / 13)
    assert torch.equal(res.null, std.null) and float(res.observed) == float(std.observed)
