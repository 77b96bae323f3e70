"""repro_torch.core.fastcv's incremental plan updates on the CPU.

``update_plan`` / ``downdate_plan`` / ``sliding_window`` against the
reference package on the same f64 arrays (every plan leaf ≤ 1e-10
relative, fold indices exactly equal), against the port's own
from-scratch ``prepare`` (the reference's pin, 1e-5 of scale), and every
``ValueError`` of the reference with its message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro_torch.core import fastcv, folds

N, P, K, LAM = 32, 80, 4, 1.0
TOL_REF = 1e-10        # the port against the reference, f64
TOL_REBUILD = 1e-5     # an updated plan against a rebuild: the reference's pin


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(scope="module")
def x_full():
    """More rows than any starting dataset so appends draw fresh ones
    (the reference test's own array)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (N + 3 * K, P),
                                      dtype=jnp.float64))


def _plans(x0, shape="kfold", dtype=torch.float64, lam=LAM):
    """(port plan, reference plan) for x0 over the same folds."""
    if shape == "kfold":
        tf, rf = folds.kfold(len(x0), K, seed=1, device="cpu"), ref_folds.kfold(len(x0), K,
                                                                                 seed=1)
    else:
        tf, rf = folds.loo(len(x0), device="cpu"), ref_folds.loo(len(x0))
    xt = torch.tensor(x0, dtype=dtype)
    return (fastcv.prepare(xt, tf, lam, mode="dual"),
            ref_fastcv.prepare(jnp.asarray(x0), rf, lam, mode="dual"))


def _same_plan(tp, rp):
    for name in ("h", "chol_ih", "h_tr_te"):
        _close(getattr(tp, name), getattr(rp, name), TOL_REF)
    for name in ("te_idx", "tr_idx"):
        got = getattr(tp, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(rp, name)))


def _matches_rebuild(plan, x_rows, lam=LAM):
    """The updated plan against the port's own prepare on its rows."""
    rebuilt = fastcv.prepare(x_rows, folds.Folds.with_indices(plan.te_idx, plan.tr_idx),
                             lam, mode="dual")
    assert plan.h.dtype == x_rows.dtype and plan.h.is_contiguous()
    for name in ("h", "chol_ih", "h_tr_te"):
        _close(getattr(plan, name), getattr(rebuilt, name), TOL_REBUILD)
    y = torch.where(torch.arange(len(x_rows)) % 2 == 0, -1.0, 1.0).to(x_rows.dtype)
    _close(fastcv.binary_dvals(plan, y, fused=True), fastcv.binary_dvals(rebuilt, y, fused=True),
           TOL_REBUILD)


@pytest.mark.parametrize("delta", ["assignment", "folds"])
def test_update_plan_matches_reference(x_full, delta):
    x0, xa = x_full[:N], x_full[N:N + K]
    tp, rp = _plans(x0)
    if delta == "assignment":       # one row per fold
        t_delta, r_delta = torch.arange(K), np.arange(K)
    else:                           # a full Folds over the N + K rows
        t_delta, r_delta = (folds.kfold(N + K, K, seed=9, device="cpu"),
                            ref_folds.kfold(N + K, K, seed=9))
    got = fastcv.update_plan(tp, torch.from_numpy(xa), t_delta, x=torch.from_numpy(x0), lam=LAM)
    want = ref_fastcv.update_plan(rp, xa, r_delta, x=x0, lam=LAM)
    _same_plan(got, want)
    _matches_rebuild(got, torch.from_numpy(np.concatenate([x0, xa])))


def test_downdate_plan_matches_reference(x_full):
    x0 = x_full[:N + K]
    tp, rp = _plans(x0)
    drop = np.asarray(rp.te_idx)[:, 0].astype(np.int64)      # one test row per fold
    got = fastcv.downdate_plan(tp, torch.from_numpy(drop), x=torch.from_numpy(x0), lam=LAM)
    want = ref_fastcv.downdate_plan(rp, drop, x=x0, lam=LAM)
    _same_plan(got, want)
    _matches_rebuild(got, torch.from_numpy(x0[np.setdiff1d(np.arange(N + K), drop)]))


@pytest.mark.parametrize("shape,delta", [("kfold", None), ("kfold", "assignment"),
                                         ("kfold", "folds"), ("loo", None)])
def test_sliding_window_matches_reference(x_full, shape, delta):
    x0 = x_full[:N]
    tp, rp = _plans(x0, shape)
    if shape == "kfold":
        drop = np.asarray(rp.te_idx)[:, 0].astype(np.int64)
    else:                           # LOO folds are width-1: only window moves keep the shape
        drop = np.array([0, 5], dtype=np.int64)
    xb = x_full[N:N + drop.size]
    kw_t, kw_r = {}, {}
    if delta == "assignment":       # the new rows re-assigned in reverse fold order
        kw_t["folds_delta"] = torch.arange(K - 1, -1, -1)
        kw_r["folds_delta"] = np.arange(K - 1, -1, -1)
    elif delta == "folds":
        kw_t["folds_delta"] = folds.kfold(N, K, seed=4, device="cpu")
        kw_r["folds_delta"] = ref_folds.kfold(N, K, seed=4)
    got = fastcv.sliding_window(tp, torch.from_numpy(xb), torch.from_numpy(drop),
                                x=torch.from_numpy(x0), lam=LAM, **kw_t)
    want = ref_fastcv.sliding_window(rp, xb, drop, x=x0, lam=LAM, **kw_r)
    _same_plan(got, want)
    x2 = np.concatenate([x0[np.setdiff1d(np.arange(N), drop)], xb])
    _matches_rebuild(got, torch.from_numpy(x2))


def test_f32_plans_advance_in_f64(x_full):
    """An f32 plan comes back f32, within the rebuild pin after an append,
    a window advance and a downdate. λ = tr(G_c)/N, the scale of the Gram's
    diagonal (the rule of the card's update path): at a λ far below it,
    I − H_Te is near-singular and f32 rounding of H alone moves its factor
    past the pin, in a rebuild as much as in an update."""
    x0 = x_full[:N].astype(np.float32)
    xc = x_full[:N] - x_full[:N].mean(axis=0)
    lam = float((xc * xc).sum()) / N
    plan, _ = _plans(x_full[:N], dtype=torch.float32, lam=lam)
    x = torch.from_numpy(x0)
    xa = torch.from_numpy(x_full[N:N + K].astype(np.float32))
    plan = fastcv.update_plan(plan, xa, np.arange(K), x=x, lam=lam)
    x = torch.cat([x, xa])
    _matches_rebuild(plan, x, lam)
    drop = plan.te_idx[:, 0].long()
    xb = torch.from_numpy(x_full[N + K:N + 2 * K].astype(np.float32))
    plan = fastcv.sliding_window(plan, xb, drop, x=x, lam=lam)
    keep = torch.from_numpy(np.setdiff1d(np.arange(len(x)), drop.numpy()))
    x = torch.cat([x[keep], xb])
    _matches_rebuild(plan, x, lam)
    drop = plan.te_idx[:, 1].long()
    plan = fastcv.downdate_plan(plan, drop, x=x, lam=lam)
    _matches_rebuild(plan, x[torch.from_numpy(np.setdiff1d(np.arange(len(x)), drop.numpy()))],
                     lam)
    assert plan.h.dtype == plan.chol_ih.dtype == torch.float32


# case: (message, call(fastcv module, its plan, array converter, x0, x_new))
ERROR_CASES = {
    "no folds_delta": ("folds_delta", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa), None, x=a(x0), lam=LAM)),
    "non-integer assignment": ("must be integer", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa), np.arange(K) + 0.5, x=a(x0), lam=LAM)),
    "ragged drop": ("ragged", lambda fc, plan, a, x0, xa: fc.downdate_plan(
        plan, np.array([0]), x=a(x0), lam=LAM)),
    "every row dropped": ("every row", lambda fc, plan, a, x0, xa: fc.downdate_plan(
        plan, np.arange(N), x=a(x0), lam=LAM)),
    "primal plan": ("dual-mode", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa[:, :10]), np.arange(K), x=a(x0[:, :10]), lam=LAM, mode="auto")),
    "lam <= 0": ("lam > 0", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa), np.arange(K), x=a(x0), lam=0.0)),
    "wrong x rows": ("rows", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa), np.arange(K), x=a(x0[:-1]), lam=LAM)),
    "x_new width": ("x_new must be", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa[:, :7]), np.arange(K), x=a(x0), lam=LAM)),
    "assignment length": ("entries", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa), np.arange(K - 1), x=a(x0), lam=LAM)),
    "ragged append": ("ragged", lambda fc, plan, a, x0, xa: fc.update_plan(
        plan, a(xa), np.array([0, 0, 1, 2]), x=a(x0), lam=LAM)),
    "duplicate drop": ("duplicate", lambda fc, plan, a, x0, xa: fc.downdate_plan(
        plan, np.array([1, 1]), x=a(x0), lam=LAM)),
    "window without folds_delta": ("len\\(x_new\\)", lambda fc, plan, a, x0, xa:
                                   fc.sliding_window(plan, a(xa[:1]), np.array([0, 1]),
                                                     x=a(x0), lam=LAM)),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_update_errors_match_reference(x_full, case):
    match, call = ERROR_CASES[case]
    tp, rp = _plans(x_full[:N])
    x0, xa = x_full[:N], x_full[N:N + K]
    with pytest.raises(ValueError, match=match) as want:
        call(ref_fastcv, rp, np.asarray, x0, xa)
    with pytest.raises(ValueError, match=match) as got:
        call(fastcv, tp, torch.from_numpy, x0, xa)
    assert str(got.value) == str(want.value)


def test_a_fold_that_is_not_positive_definite_raises(x_full):
    """_finish_plan factors I − H_Te by Cholesky and raises on a fold that
    is not positive definite, as the reference does (``prepare`` gives such
    a fold a NaN factor instead). A plan whose H has eigenvalues past 1
    makes every updated fold block negative definite."""
    x0 = x_full[:N + K]
    tp, rp = _plans(x0)
    eye = np.eye(N + K)
    tp.h = tp.h + 1.5 * torch.from_numpy(eye)
    rp = ref_fastcv.CVPlan(rp.h + 1.5 * jnp.asarray(eye), rp.te_idx, rp.tr_idx, rp.chol_ih,
                           rp.h_tr_te)
    drop = np.asarray(rp.te_idx)[:, 0].astype(np.int64)
    with pytest.raises(np.linalg.LinAlgError):
        ref_fastcv.downdate_plan(rp, drop, x=x0, lam=LAM)
    with pytest.raises(torch.linalg.LinAlgError):
        fastcv.downdate_plan(tp, torch.from_numpy(drop), x=torch.from_numpy(x0), lam=LAM)


@pytest.mark.parametrize("which", ["x", "x_new"])
@pytest.mark.parametrize("where", ["meta", "numpy"])
def test_update_refuses_inputs_off_the_plan_device(x_full, which, where):
    """x and x_new must be tensors on the plan's device: never moved quietly."""
    tp, _ = _plans(x_full[:N])
    arrays = {"x": x_full[:N], "x_new": x_full[N:N + K]}
    args = {k: torch.from_numpy(v) for k, v in arrays.items()}
    args[which] = torch.from_numpy(arrays[which]).to("meta") if where == "meta" \
        else arrays[which]
    with pytest.raises(ValueError, match=f"{which} must be a tensor on the plan's device"):
        fastcv.update_plan(tp, args["x_new"], np.arange(K), x=args["x"], lam=LAM)
    with pytest.raises(ValueError, match=f"{which} must be a tensor on the plan's device"):
        fastcv.sliding_window(tp, args["x_new"], tp.te_idx[:, 0], x=args["x"], lam=LAM)
