"""repro_torch RSA (cross-validated RDMs, pattern RDMs, model comparison
and condition-permutation nulls) on the CPU, against the reference package
on the same numpy inputs.

Plans are built by the reference and carried over with
``fastcv.plan_from_arrays(reference plan_to_arrays)``. Tolerances: pair
lists, contrast columns, accuracy and confusion RDMs exactly equal at f64;
contrast RDMs ≤ 1e-9 relative; rank and correlation scores and
permutation nulls ≤ 1e-12 absolute (they are bounded by 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro.core import permutation as ref_permutation
from repro.kernels.pairdist.ref import pairwise_sq_dists_ref as ref_pairwise_sq_dists_ref
from repro.rsa import compare as ref_compare
from repro.rsa import rdm as ref_rdm
from repro_torch import rsa
from repro_torch.core import fastcv, folds
from repro_torch.kernels import _build
from repro_torch.kernels.pairdist import pairdist as pairdist_launch
from repro_torch.kernels.pairdist.ref import pairwise_sq_dists_ref
from repro_torch.rsa import compare, rdm

TOL = 1e-9
SCORE_TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _problem(n=96, p=150, c=6, seed=0, k=4):
    """Condition labels cycle through C conditions with distinct patterns."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % c).astype(np.int32)
    x = rng.normal(size=(n, p)) + 0.8 * rng.normal(size=(c, p))[y]
    rf = ref_folds.stratified_kfold(y, k, seed=seed)
    tf = folds.stratified_kfold(y, k, seed=seed, device="cpu")
    return x, y, rf, tf


def _plans(x, rf, lam, with_train_block=True):
    rp = ref_fastcv.prepare(jnp.asarray(x), rf, lam, with_train_block=with_train_block)
    return rp, fastcv.plan_from_arrays(ref_fastcv.plan_to_arrays(rp), device="cpu")


def _check_rdm(r, c):
    r = torch.as_tensor(r)
    assert r.shape == (c, c) and torch.isfinite(r).all()
    assert torch.equal(r, r.T) and torch.equal(torch.diagonal(r), torch.zeros(c, dtype=r.dtype))


def test_package_exports_the_reference_names_less_searchlight():
    import repro.rsa as ref_rsa
    want = {n for n in dir(ref_rsa) if not n.startswith("_")} - {"searchlight_rdm"}
    got = {n for n in dir(rsa) if not n.startswith("_")}
    assert want <= got


# ------------------------------------------------------ pairs, columns ----

@pytest.mark.parametrize("c", [2, 3, 6, 8])
def test_condition_pairs_and_contrast_columns_equal_reference(c):
    np.testing.assert_array_equal(rdm.condition_pairs(c), ref_rdm.condition_pairs(c))
    assert rdm.condition_pairs(c).dtype == np.int32
    y = np.random.default_rng(c).integers(0, c, size=40).astype(np.int32)
    got = rdm.pair_contrast_columns(torch.tensor(y), c)
    assert got.dtype == torch.float64 and got.shape == (40, c * (c - 1) // 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_rdm.pair_contrast_columns(jnp.asarray(y), c)))
    vals = np.arange(1.0, c * (c - 1) // 2 + 1)
    np.testing.assert_array_equal(
        rdm.rdm_from_pair_values(torch.tensor(vals), c).numpy(),
        np.asarray(ref_rdm.rdm_from_pair_values(jnp.asarray(vals), c)))


# ------------------------------------------------------- empirical RDMs ----

@pytest.mark.parametrize("fused", [False, True])
def test_accuracy_rdm_equals_reference_exactly(fused):
    x, y, rf, tf = _problem(seed=1)
    rp, tp = _plans(x, rf, 5.0)
    want = ref_rdm.rdm_binary(jnp.asarray(x), jnp.asarray(y), rf, 6, plan=rp)
    got = rdm.rdm_binary(torch.tensor(x), torch.tensor(y), tf, 6, plan=tp, fused=fused)
    _check_rdm(got, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one-shot (plan built inside) gives the same RDM
    own = rdm.rdm_binary(torch.tensor(x), torch.tensor(y), tf, 6, 5.0, fused=fused)
    np.testing.assert_array_equal(own.numpy(), got.numpy())


@pytest.mark.parametrize("adjust_bias", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_contrast_rdm_equals_reference(adjust_bias, fused):
    x, y, rf, tf = _problem(seed=2)
    rp, tp = _plans(x, rf, 5.0, with_train_block=adjust_bias)
    want = ref_rdm.rdm_binary(jnp.asarray(x), jnp.asarray(y), rf, 6, plan=rp,
                              dissimilarity="contrast", adjust_bias=adjust_bias)
    got = rdm.rdm_binary(torch.tensor(x), torch.tensor(y), tf, 6, plan=tp,
                         dissimilarity="contrast", adjust_bias=adjust_bias, fused=fused)
    _check_rdm(got, 6)
    _close(got, want)


@pytest.mark.parametrize("dissimilarity", ["accuracy", "contrast"])
def test_pair_dissimilarities_without_bias_adjust_on_a_train_block_plan(dissimilarity,
                                                                      monkeypatch):
    """adjust_bias=False on a plan with train blocks equals the reference's
    values, and its kernel route is the fused fold_eval one."""
    x, y, rf, _ = _problem(seed=3)
    rp, tp = _plans(x, rf, 5.0)
    cols = rdm.pair_contrast_columns(torch.tensor(y), 6)
    want = ref_rdm.pair_dissimilarities(rp, jnp.asarray(cols.numpy()), dissimilarity,
                                        adjust_bias=False)
    _close(rdm.pair_dissimilarities(tp, cols, dissimilarity, adjust_bias=False), want)
    calls = []
    real = fastcv.fold_eval
    monkeypatch.setattr(fastcv, "fold_eval", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = rdm.make_eval_pairs(dissimilarity, adjust_bias=False, fused=True)(tp, cols)
    assert calls, "the fused route did not take fold_eval"
    _close(got, want, 1e-8)


def test_pair_dissimilarities_rejects_bad_options():
    x, y, rf, _ = _problem(n=40, c=4, seed=4)
    _, tp = _plans(x, rf, 5.0, with_train_block=False)
    cols = rdm.pair_contrast_columns(torch.tensor(y), 4)
    with pytest.raises(ValueError, match="dissimilarity"):
        rdm.pair_dissimilarities(tp, cols, "euclid")
    with pytest.raises(ValueError, match="with_train_block"):
        rdm.pair_dissimilarities(tp, cols, adjust_bias=True)


@pytest.mark.parametrize("fused", [False, True])
def test_confusion_rdm_equals_reference_exactly(fused):
    x, y, rf, _ = _problem(seed=5)
    rp, tp = _plans(x, rf, 5.0)
    want = ref_rdm.rdm_multiclass(rp, jnp.asarray(y), 6)
    got = rdm.rdm_multiclass(tp, torch.tensor(y), 6, fused=fused)
    _check_rdm(got, 6)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    preds = np.random.default_rng(0).integers(0, 6, size=(4, 24))
    y_te = np.random.default_rng(1).integers(0, 6, size=(4, 24))
    np.testing.assert_array_equal(
        rdm.rdm_from_confusion(torch.tensor(preds), torch.tensor(y_te), 6).numpy(),
        np.asarray(ref_rdm.rdm_from_confusion(jnp.asarray(preds), jnp.asarray(y_te), 6)))


# --------------------------------------------------------- pattern RDMs ----

def test_condition_means_ring_and_euclidean_rdm_equal_reference():
    x, y, _, _ = _problem(seed=6)
    means = rdm.condition_means(torch.tensor(x), torch.tensor(y), 6)
    want_means = ref_rdm.condition_means(jnp.asarray(x), jnp.asarray(y), 6)
    _close(means, want_means, 1e-12)
    np.testing.assert_array_equal(rdm.ring_rdm(7, device="cpu").numpy(),
                                  np.asarray(ref_rdm.ring_rdm(7)))
    assert rdm.ring_rdm(5, torch.float32, device="cpu").dtype == torch.float32
    want = ref_rdm.euclidean_rdm(jnp.asarray(means.numpy()), impl="xla")
    got = rdm.euclidean_rdm(means)
    assert (got >= 0).all()
    _close(got, want)


def test_euclidean_rdm_auto_on_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel or its build."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route was taken for a CPU tensor")
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(pairdist_launch, "pairdist_cuda", refuse)
    u = torch.tensor(np.random.default_rng(0).normal(size=(5, 30)))
    got = rdm.euclidean_rdm(u)
    np.testing.assert_array_equal(got.numpy(),
                                  pairwise_sq_dists_ref(u).numpy())
    _close(got, ref_pairwise_sq_dists_ref(jnp.asarray(u.numpy())))


def test_ring_rdm_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rdm.ring_rdm(4)


# ----------------------------------------------------------- comparison ----

def _tied_vectors(seed, b=28):
    rng = np.random.default_rng(seed)
    a = np.round(rng.normal(size=b), 1)          # ties exercise the mid-ranks
    c = np.round(rng.normal(size=b) + 0.5 * a, 1)
    return a, c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_and_scores_equal_reference(seed):
    a, b = _tied_vectors(seed)
    assert len(np.unique(a)) < len(a)
    _close(compare.rankdata(torch.tensor(a)), ref_compare.rankdata(jnp.asarray(a)), SCORE_TOL)
    for name in ("pearson", "spearman", "kendall", "cosine"):
        got = getattr(compare, name)(torch.tensor(a), torch.tensor(b))
        want = getattr(ref_compare, name)(jnp.asarray(a), jnp.asarray(b))
        assert abs(float(got) - float(want)) <= SCORE_TOL, name
    # batched rows score as rows one by one
    rows = np.stack([a, b, a[::-1]])
    np.testing.assert_array_equal(
        compare.rankdata(torch.tensor(rows)).numpy(),
        np.stack([compare.rankdata(torch.tensor(r)).numpy() for r in rows]))


def test_constant_vectors_score_zero_not_nan():
    z = torch.zeros(10, dtype=torch.float64)
    v = torch.arange(10, dtype=torch.float64)
    for name in ("pearson", "spearman", "kendall", "cosine"):
        assert float(getattr(compare, name)(z, v)) == float(
            getattr(ref_compare, name)(jnp.zeros(10), jnp.arange(10.0)))


def _rdms(c=6, m=3, seed=7):
    rng = np.random.default_rng(seed)
    def sym(a):
        r = np.round(np.abs(a + a.T), 1)
        np.fill_diagonal(r, 0.0)
        return r
    emp = sym(rng.normal(size=(c, c)))
    models = np.stack([sym(rng.normal(size=(c, c))) for _ in range(m - 1)]
                      + [np.asarray(ref_rdm.ring_rdm(c))])
    return emp, models


@pytest.mark.parametrize("method", ["spearman", "kendall", "pearson", "cosine"])
def test_compare_rdms_and_permutation_null_equal_reference(method):
    emp, models = _rdms()
    np.testing.assert_array_equal(compare.upper_triangle(torch.tensor(models)).numpy(),
                                  np.asarray(ref_compare.upper_triangle(jnp.asarray(models))))
    got = compare.compare_rdms(torch.tensor(emp), torch.tensor(models), method)
    want = ref_compare.compare_rdms(jnp.asarray(emp), jnp.asarray(models), method)
    assert got.shape == (3,)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= SCORE_TOL
    perms = np.asarray(ref_permutation.permutation_indices(jax.random.PRNGKey(2), 6, 40))
    null = compare.permutation_null(torch.tensor(emp), torch.tensor(models),
                                    torch.tensor(perms), method)
    null_ref = ref_compare.permutation_null(jnp.asarray(emp), jnp.asarray(models),
                                            jnp.asarray(perms), method)
    assert null.shape == (3, 40)
    assert float(np.max(np.abs(null.numpy() - np.asarray(null_ref)))) <= SCORE_TOL
    assert torch.equal(compare.make_compare(method)(torch.tensor(emp), torch.tensor(models)), got)
    assert torch.equal(compare.make_compare_null(method)(torch.tensor(emp), torch.tensor(models),
                                                         torch.tensor(perms)), null)


def test_unknown_comparison_raises():
    emp, models = _rdms()
    with pytest.raises(ValueError, match="unknown comparison"):
        compare.compare_rdms(torch.tensor(emp), torch.tensor(models), "dcor")


# --------------------------------------------------------------- cache ----

def test_rdm_cache_hits_misses_and_eviction():
    cache = rdm.RDMCache(max_entries=2)
    assert cache.get("a") is None and (cache.hits, cache.misses) == (0, 1)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1 and cache.hits == 1          # "a" is now the newest
    cache.put("c", 3)                                       # evicts "b", the oldest
    assert "b" not in cache and "a" in cache and "c" in cache and len(cache) == 2
    assert cache.get("b") is None and cache.misses == 2
    cache.clear()
    assert len(cache) == 0
    with pytest.raises(ValueError, match="max_entries"):
        rdm.RDMCache(max_entries=0)


# ------------------------------------------------------------ end to end ----

def test_rsa_end_to_end_in_the_port():
    """The chip script's RSA sequence at a small size: every RDM symmetric
    with a zero diagonal, and the ring model found in ring-structured data."""
    c, n, p = 6, 120, 80
    rng = np.random.default_rng(11)
    angles = 2 * np.pi * np.arange(c) / c
    basis = rng.normal(size=(2, p))
    centers = 3.0 * (np.cos(angles)[:, None] * basis[0] + np.sin(angles)[:, None] * basis[1])
    y = np.arange(n) % c
    x = torch.tensor(rng.normal(size=(n, p)) + centers[y])
    yt = torch.tensor(y)
    tf = folds.stratified_kfold(y, 5, seed=0, device="cpu")
    plan = fastcv.prepare(x, tf, 10.0)
    emp = rdm.rdm_binary(x, yt, tf, c, plan=plan, dissimilarity="contrast")
    for r in (emp, rdm.rdm_binary(x, yt, tf, c, plan=plan), rdm.rdm_multiclass(plan, yt, c)):
        _check_rdm(r, c)
    eu = rdm.euclidean_rdm(rdm.condition_means(x, yt, c))
    models = torch.stack([rdm.ring_rdm(c, device="cpu"), eu])
    scores = compare.compare_rdms(emp, models, "spearman")
    perms = torch.tensor(np.asarray(ref_permutation.permutation_indices(
        jax.random.PRNGKey(0), c, 50)))
    null = compare.permutation_null(emp, models, perms, "spearman")
    assert float(scores[0]) > 0.8 and null.shape == (2, 50)
