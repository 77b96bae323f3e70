"""repro_torch.core.{shrinkage,tuning,multidim} on the CPU against the
reference package.

The same arrays (the reference's own generators, as its tests draw them)
go through both packages in f64. Scalars and curves agree to ≤ 1e-10
relative to their largest magnitude, accuracy vectors and matrices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro.core import multidim as ref_multidim
from repro.core import shrinkage as ref_shrinkage
from repro.core import tuning as ref_tuning
from repro.data import synthetic
from repro_torch.core import fastcv, folds, multidim, regression, shrinkage, tuning

TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


def _t(a):
    return torch.from_numpy(np.array(a))


def _classification(seed, n, p, **kw):
    x, yc = synthetic.make_classification(jax.random.PRNGKey(seed), n, p, **kw)
    return np.asarray(x), np.where(np.asarray(yc) == 0, -1.0, 1.0)


def _regression(seed, n, p, **kw):
    x, y = synthetic.make_regression(jax.random.PRNGKey(seed), n, p, **kw)
    return np.asarray(x), np.asarray(y)


# ---------------------------------------------------------------------------
# shrinkage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_y", [False, True])
def test_trace_scaling_matches_reference(with_y):
    x, y = _classification(0, 50, 20)
    args = (x, y) if with_y else (x,)
    _close(shrinkage.trace_scaling(*map(_t, args)),
           ref_shrinkage.trace_scaling(*map(jnp.asarray, args)))


def test_shrink_to_ridge_matches_reference():
    x, y = _classification(0, 50, 20)
    nu = shrinkage.trace_scaling(_t(x), _t(y))
    for lam_s in (0.0, 0.3, 0.9):
        _close(shrinkage.shrink_to_ridge(lam_s, nu),
               ref_shrinkage.shrink_to_ridge(lam_s, float(nu)))


def _isotropic(n, p):
    """Many samples of a standard normal: S ≈ I = μI, d² small."""
    return np.random.default_rng(3).normal(size=(n, p))


@pytest.mark.parametrize("case", ["gram P>N", "gram P>>N", "square P<=N", "tall P<N",
                                  "S near muI"])
def test_ledoit_wolf_matches_reference(case, monkeypatch):
    x = {"gram P>N": lambda: _classification(1, 40, 60)[0],
         "gram P>>N": lambda: _classification(2, 30, 400)[0],
         "square P<=N": lambda: _classification(3, 40, 40)[0],
         "tall P<N": lambda: _classification(4, 60, 20)[0],
         "S near muI": lambda: _isotropic(4000, 6)}[case]()
    grams = []
    real = shrinkage.centered_gram
    monkeypatch.setattr(shrinkage, "centered_gram", lambda a: grams.append(a) or real(a))
    got = shrinkage.ledoit_wolf_lambda(_t(x))
    want = ref_shrinkage.ledoit_wolf_lambda(jnp.asarray(x))
    _close(got, want)
    assert 0.0 <= float(got) <= 1.0
    # the N×N Gram form exactly when P > N; else the reference's P×P form
    assert len(grams) == (x.shape[1] > x.shape[0])


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("criterion", ["mse", "error"])
def test_loo_curve_matches_reference(criterion):
    if criterion == "mse":
        x, y = _regression(0, 40, 120)
    else:
        x, y = _classification(2, 50, 200, class_sep=2.0)
    lambdas = np.asarray([0.5, 5.0, 50.0])
    # a Python list of λ is taken in f64, as the reference takes it under x64
    grid = lambdas.tolist() if criterion == "mse" else _t(lambdas)
    got = tuning.loo_curve(_t(x), _t(y), grid, criterion=criterion)
    want = ref_tuning.loo_curve(jnp.asarray(x), jnp.asarray(y), jnp.asarray(lambdas),
                                criterion=criterion)
    _close(got, want)
    assert got.dtype == torch.float64
    if criterion == "mse":     # the reference's own pin: explicit plan-based LOO
        f = folds.loo(x.shape[0], device="cpu")
        for i, lam in enumerate(lambdas):
            preds, y_te = regression.analytical_cv(_t(x), _t(y), f, lam=float(lam))
            assert float(got[i]) == pytest.approx(float(((preds - y_te) ** 2).mean()),
                                                  rel=1e-6)


@pytest.mark.parametrize("criterion", ["mse", "error"])
def test_tune_ridge_matches_reference(criterion):
    if criterion == "mse":
        x, y = _regression(1, 60, 400, noise=0.5)
    else:
        x, y = _classification(2, 50, 200, class_sep=2.0)
    got = tuning.tune_ridge(_t(x), _t(y), criterion=criterion)
    want = ref_tuning.tune_ridge(jnp.asarray(x), jnp.asarray(y), criterion=criterion)
    _close(got.lambdas, want.lambdas)
    assert got.lambdas.shape == (25,)
    assert int(torch.argmin(got.scores)) == int(jnp.argmin(want.scores))
    _close(got.best_lambda, want.best_lambda)
    _close(got.best_score, want.best_score)
    # over the whole grid: at its small end (λ = 1e-4·tr(G_c)/N) 1 − H_ii is
    # ~1e-4 and both packages' f64 curves carry the rounding of an N×N
    # eigendecomposition magnified by ~1e4, so the grid is held at 1e-8
    _close(got.scores, want.scores, 1e-8)


def test_loo_curve_f32_holds_the_f64_curve():
    """An f32 design gives the f64 curve to 1e-4 (relative) over the whole
    default grid: the spectral work after the Gram runs in f64 on a Gram
    projected onto the complement of 1, so the grid's small end, where
    1 − H_ii ≈ 1e-4, is not left to f32 rounding."""
    rng = np.random.default_rng(5)
    mix = rng.normal(size=(40, 40)) / 40 ** 0.5      # spatially mixed channels
    x = (rng.normal(size=(120, 50, 40)) @ mix.T).reshape(120, 2000)
    y = np.where(rng.random(120) < 0.5, -1.0, 1.0)
    r64 = tuning.tune_ridge(_t(x), _t(y))
    r32 = tuning.tune_ridge(_t(x.astype(np.float32)), _t(y.astype(np.float32)))
    assert r32.scores.dtype == torch.float32
    _close(r32.lambdas, r64.lambdas, 1e-6)
    rel = (r32.scores.double() - r64.scores).abs() / r64.scores.abs()
    assert float(rel.max()) <= 1e-4


# ---------------------------------------------------------------------------
# multidim (the reference test's own shapes)
# ---------------------------------------------------------------------------


def _grid_problem(n=32, p=64, q=4, seed=5):
    keys = jax.random.split(jax.random.PRNGKey(seed), q)
    xs = np.stack([np.asarray(synthetic.make_classification(kk, n, p, class_sep=2.0)[0])
                   for kk in keys])
    _, yc = synthetic.make_classification(keys[0], n, p)
    return xs, np.where(np.asarray(yc) == 0, -1.0, 1.0)


@pytest.mark.parametrize("adjust_bias", [True, False])
def test_cv_grid_matches_reference(adjust_bias):
    xs, y = _grid_problem()
    got = multidim.cv_grid(_t(xs), _t(y), folds.kfold(32, 4, seed=2, device="cpu"), 1.0,
                           adjust_bias=adjust_bias)
    want = ref_multidim.cv_grid(jnp.asarray(xs), jnp.asarray(y), ref_folds.kfold(32, 4, seed=2),
                                1.0, adjust_bias=adjust_bias)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_weights_match_reference():
    n, p, k, lam = 36, 90, 4, 2.0
    x, y = _classification(3, n, p)
    ws, bs = multidim.fold_weights(_t(x), _t(y), folds.kfold(n, k, seed=0, device="cpu"), lam)
    ws_ref, bs_ref = ref_multidim.fold_weights(jnp.asarray(x), jnp.asarray(y),
                                               ref_folds.kfold(n, k, seed=0), lam)
    _close(ws, ws_ref)
    _close(bs, bs_ref)


def test_fold_weights_reproduce_analytical_dvals():
    """x_te @ w_k + b_k equals the port's own Eq.-14 decision values."""
    n, p, k, lam = 40, 150, 5, 1.0
    x, y = _classification(4, n, p)
    f = folds.kfold(n, k, seed=1, device="cpu")
    ws, bs = multidim.fold_weights(_t(x), _t(y), f, lam)
    dv_fast, _ = fastcv.binary_cv(_t(x), _t(y), f, lam=lam, adjust_bias=False)
    dv_ref, _ = ref_fastcv.binary_cv(jnp.asarray(x), jnp.asarray(y), ref_folds.kfold(n, k, seed=1),
                                     lam=lam, adjust_bias=False)
    dv_w = torch.einsum("kmp,kp->km", _t(x)[f.te_idx.long()], ws) + bs[:, None]
    _close(dv_w, dv_fast, 1e-9)
    _close(dv_w, dv_ref, 1e-9)


def test_time_generalization_matches_reference():
    n, p = 48, 80
    key = jax.random.PRNGKey(6)
    x_sig, yc = synthetic.make_classification(key, n, p, class_sep=3.0)
    y = np.where(np.asarray(yc) == 0, -1.0, 1.0)
    x_noise = jax.random.normal(jax.random.fold_in(key, 1), (n, p), x_sig.dtype)
    xs = np.stack([np.asarray(x_sig), np.asarray(x_noise), 0.5 * np.asarray(x_sig)])
    got = multidim.time_generalization(_t(xs), _t(y), folds.kfold(n, 4, seed=3, device="cpu"),
                                       1.0)
    want = ref_multidim.time_generalization(jnp.asarray(xs), jnp.asarray(y),
                                            ref_folds.kfold(n, 4, seed=3), 1.0)
    assert got.shape == (3, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) > 0.8                 # signal decodes
    # the diagonal is ordinary CV with the regression bias (Eq. 14)
    grid = multidim.cv_grid(_t(xs), _t(y), folds.kfold(n, 4, seed=3, device="cpu"), 1.0,
                            adjust_bias=False)
    np.testing.assert_array_equal(torch.diagonal(got).numpy(), grid.numpy())
