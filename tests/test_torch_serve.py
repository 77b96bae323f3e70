"""repro_torch.serve's engine, cache and batcher on the CPU, against the
reference package.

The same f64 inputs go through both engines (``device="cpu"``): decision
values, ridge predictions, multi-class predictions, RSA pair values and
the permutation-path metrics agree to ≤ 1e-9 relative; nulls and model
scores on shared explicit draws to ≤ 1e-12. Beside them the port's own
contracts: the plan cache's byte-budget LRU, pinning and oversize
admission against the reference's on the same traffic; the batcher's
segments and padding against the reference's; ``compile_count`` flat
after a warm-up that covers the traffic's buckets; ``donate=True`` never
touches a caller's batch; handle traffic never fingerprints X again, and
a registered handle rebuilds from its own copy of X and the folds;
versioned updates against the reference's; ``CVEngine()`` raising without
a card.
"""

import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folds as ref_folds
from repro.serve import CVEngine as RefEngine
from repro.serve import EngineConfig as RefConfig
from repro.serve import MicroBatcher as RefBatcher
from repro.serve import PlanCache as RefCache
from repro.serve import bucket_size as ref_bucket_size
from repro_torch.core import fastcv, folds
from repro_torch.core import permutation as perm_lib
from repro_torch.serve import (CVEngine, DatasetSpec, EngineConfig, MicroBatcher, PlanCache,
                               Workload, as_folds, bucket_size, run_workloads)

N, P, K, LAM, C = 48, 120, 4, 1.0, 3
TOL = 1e-9          # f64 results against the reference (tests/test_torch_fastcv.py)
TOL_SHARED = 1e-12  # scores and p-values on shared draws


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, P))
    yc = (np.arange(N) % C).astype(np.int64)
    y = np.where(yc % 2 == 0, -1.0, 1.0)
    x[y > 0, :5] += 0.8
    x[:, 5:8] += 0.6 * yc[:, None]
    return x, y, yc


@pytest.fixture(scope="module")
def engines(problem):
    """(port engine, its plan, reference engine, its plan) over one dataset."""
    x = problem[0]
    port = CVEngine(EngineConfig(device="cpu"))
    ref = RefEngine(RefConfig())
    _, plan = port.plan(torch.tensor(x), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    _, ref_plan = ref.plan(jnp.asarray(x), ref_folds.kfold(N, K, seed=1), LAM)
    return port, plan, ref, ref_plan


def _perms(seed, n, t):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(t)])


# ---------------------------------------------------------------------------
# The engine's eval surface against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 3, 4])
def test_cv_evals_match_reference(problem, engines, width):
    x, y, yc = problem
    port, plan, ref, ref_plan = engines
    ys = np.stack([np.roll(y, 5 * j) for j in range(width)], axis=1)
    rows = np.stack([np.roll(yc, 7 * j) for j in range(width)])
    if width == 1:
        ys, rows = ys[:, 0], rows[0]
    for adjust in (True, False):
        _close(port.eval_binary(plan, torch.tensor(ys), adjust),
               ref.eval_binary(ref_plan, jnp.asarray(ys), adjust))
    _close(port.eval_ridge(plan, torch.tensor(ys)), ref.eval_ridge(ref_plan, jnp.asarray(ys)))
    np.testing.assert_array_equal(port.eval_multiclass(plan, torch.tensor(rows), C).numpy(),
                                  np.asarray(ref.eval_multiclass(ref_plan, jnp.asarray(rows), C)))


@pytest.mark.parametrize("dissimilarity,adjust", [("accuracy", True), ("contrast", False)])
def test_rsa_pairs_and_scoring_match_reference(problem, engines, dissimilarity, adjust):
    from repro.rsa import rdm as ref_rdm
    from repro_torch.rsa import rdm

    _, _, yc = problem
    port, plan, ref, ref_plan = engines
    cols = rdm.pair_contrast_columns(torch.tensor(yc), C, torch.float64)
    got = port.eval_rsa_pairs(plan, cols, dissimilarity, adjust)
    want = ref.eval_rsa_pairs(ref_plan, ref_rdm.pair_contrast_columns(jnp.asarray(yc), C,
                                                                      jnp.float64),
                              dissimilarity, adjust)
    _close(got, want)
    emp = rdm.rdm_from_pair_values(got, C)
    models = np.stack([1.0 - np.eye(C), np.abs(np.arange(C)[:, None] - np.arange(C))])
    perms = _perms(4, C, 6)
    for method in ("spearman", "pearson", "kendall", "cosine"):
        _close(port.score_rdms(emp, torch.tensor(models), method),
               ref.score_rdms(jnp.asarray(emp.numpy()), jnp.asarray(models), method),
               TOL_SHARED)
        _close(port.null_rdm_scores(emp, torch.tensor(models), torch.tensor(perms), method),
               ref.null_rdm_scores(jnp.asarray(emp.numpy()), jnp.asarray(models),
                                   jnp.asarray(perms, jnp.int32), method), TOL_SHARED)


@pytest.mark.parametrize("metric,adjust", [("accuracy", True), ("auc", True),
                                           ("accuracy", False)])
def test_binary_nulls_on_shared_draws(problem, engines, metric, adjust):
    _, y, _ = problem
    port, plan, ref, ref_plan = engines
    perms = _perms(1, N, 5)
    _close(port.observed_binary(plan, torch.tensor(y), metric=metric, adjust_bias=adjust),
           ref.observed_binary(ref_plan, jnp.asarray(y), metric=metric, adjust_bias=adjust),
           TOL_SHARED)
    _close(port.null_binary(plan, torch.tensor(y), torch.tensor(perms), metric=metric,
                            adjust_bias=adjust),
           ref.null_binary(ref_plan, jnp.asarray(y), jnp.asarray(perms, jnp.int32),
                           metric=metric, adjust_bias=adjust), TOL_SHARED)


def test_multiclass_nulls_on_shared_draws(problem, engines):
    _, _, yc = problem
    port, plan, ref, ref_plan = engines
    perms = _perms(2, N, 3)
    _close(port.observed_multiclass(plan, torch.tensor(yc), num_classes=C),
           ref.observed_multiclass(ref_plan, jnp.asarray(yc, jnp.int32), num_classes=C),
           TOL_SHARED)
    _close(port.null_multiclass(plan, torch.tensor(yc), torch.tensor(perms), num_classes=C),
           ref.null_multiclass(ref_plan, jnp.asarray(yc, jnp.int32),
                               jnp.asarray(perms, jnp.int32), num_classes=C), TOL_SHARED)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_permutation_entry_points_draw_prefix_stable(problem, engines, kind):
    """permutation_* draw T rows from the seed at the bucket of T: the
    null equals null_* on ``permutation_indices(seed, N, T)``, and the
    p-value is the core's formula on it."""
    _, y, yc = problem
    port, plan, _, _ = engines
    labels = torch.tensor(y if kind == "binary" else yc)
    call = (port.permutation_binary if kind == "binary" else
            lambda *a: port.permutation_multiclass(*a, num_classes=C))
    res = call(plan, labels, 5, 9)
    perms = perm_lib.permutation_indices(9, N, 5, device="cpu")
    null = (port.null_binary(plan, labels, perms) if kind == "binary"
            else port.null_multiclass(plan, labels, perms, num_classes=C))
    assert torch.equal(res.null, null)
    assert float(res.p) == float(perm_lib.p_value(res.observed, null))


def test_tune_matches_reference(problem, engines):
    """On an explicit grid every score; on the default grid (whose small
    end magnifies eigh's rounding ~1e4, tests/test_torch_tuning.py) the
    grid itself and the choice."""
    x, y, _ = problem
    port, _, ref, _ = engines
    lambdas = np.asarray([0.5, 5.0, 50.0])
    got = port.tune(torch.tensor(x), torch.tensor(y), torch.tensor(lambdas))
    want = ref.tune(jnp.asarray(x), jnp.asarray(y), jnp.asarray(lambdas))
    _close(got.scores, want.scores)
    got, want = port.tune(torch.tensor(x), torch.tensor(y)), ref.tune(jnp.asarray(x),
                                                                       jnp.asarray(y))
    _close(got.lambdas, want.lambdas)
    assert int(torch.argmin(got.scores)) == int(jnp.argmin(want.scores))
    _close(got.best_lambda, want.best_lambda)


# ---------------------------------------------------------------------------
# Batching and buckets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 3, 5, 31, 1024, 1025, 2100])
def test_bucket_size_matches_reference(b):
    assert bucket_size(b) == ref_bucket_size(b)
    assert bucket_size(b, (3, 7)) == ref_bucket_size(b, (3, 7))


def test_batcher_matches_reference():
    rng = np.random.default_rng(7)
    cols = [rng.normal(size=(6,)), rng.normal(size=(6, 2)), rng.normal(size=(6, 3))]
    rows = [np.arange(6) % 3, np.stack([np.arange(6) % 2, np.arange(6) % 3])]
    mine, ref = MicroBatcher(), RefBatcher()
    batch, segs, width = mine.coalesce_columns([torch.tensor(c) for c in cols])
    rbatch, rsegs, rwidth = ref.coalesce_columns([jnp.asarray(c) for c in cols])
    fields = lambda ss: [(s.start, s.stop, s.squeeze) for s in ss]
    assert (width, fields(segs)) == (rwidth, fields(rsegs))
    assert batch.is_contiguous() and batch.shape == (6, 8)
    np.testing.assert_array_equal(batch.numpy(), np.asarray(rbatch))
    split = mine.split_columns(batch * 2, segs)
    for got, c in zip(split, cols):
        np.testing.assert_array_equal(got.numpy(), 2 * c)
    batch, segs, width = mine.coalesce_rows([torch.tensor(r) for r in rows])
    rbatch, rsegs, rwidth = ref.coalesce_rows([jnp.asarray(r) for r in rows])
    assert width == rwidth == 3 and batch.shape == (4, 6)
    np.testing.assert_array_equal(batch.numpy(), np.asarray(rbatch))   # pads repeat row 0
    np.testing.assert_array_equal(mine.run_rows([torch.tensor(r) for r in rows],
                                                lambda b: b + 1)[1].numpy(), rows[1] + 1)


def test_as_folds_places_indices_on_the_device():
    f = folds.kfold(12, 3, seed=0, device="cpu")
    assert as_folds(f, "cpu") is f
    pair = as_folds((np.asarray(f.te_idx), np.asarray(f.tr_idx)), "cpu")
    assert pair.te_idx.dtype == torch.int32 and torch.equal(pair.tr_idx, f.tr_idx)
    assert pair.n == 12 and pair.k == 3


# ---------------------------------------------------------------------------
# The plan cache against the reference's on the same traffic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Sized:
    nbytes: int


def test_plan_cache_matches_reference_accounting():
    mine, ref = PlanCache(byte_budget=100), RefCache(byte_budget=100)
    script = [("put", "a", 40), ("put", "b", 40), ("get", "a"), ("pin", "a"),
              ("put", "c", 50), ("put", "huge", 500), ("get", "b"), ("unpin", "a"),
              ("put", "d", 30), ("remove", "c"), ("get", "a"), ("put", "a", 20)]
    for op, key, *size in script:
        outs = [getattr(cache, op)(key, *[_Sized(s) for s in size]) for cache in (mine, ref)]
        if op == "get":
            outs = [None if o is None else o.nbytes for o in outs]
        assert outs[0] == outs[1], (op, key)
        assert mine.stats.as_dict() == ref.stats.as_dict(), (op, key)
        assert sorted(mine.pinned_keys()) == sorted(ref.pinned_keys())
    assert mine.get_or_build("e", lambda: _Sized(10))[1] is False
    assert mine.get_or_build("e", lambda: _Sized(10))[1] is True
    mine.clear()
    assert len(mine) == 0 and mine.stats.bytes_in_use == 0


def test_engine_evicts_under_its_byte_budget(problem):
    x = torch.tensor(problem[0])
    engine = CVEngine(EngineConfig(device="cpu", cache_bytes=1))
    f = folds.kfold(N, K, seed=1, device="cpu")
    _, plan = engine.plan(x, f, LAM)
    assert engine.cache.stats.oversized == 1 and len(engine.cache) == 0  # served un-cached
    engine = CVEngine(EngineConfig(device="cpu", cache_bytes=int(plan.nbytes * 1.5)))
    for lam in (1.0, 2.0, 3.0):
        engine.plan(x, f, lam)
    assert len(engine.cache) == 1 and engine.cache.stats.evictions == 2
    assert engine.plans_built == 3


# ---------------------------------------------------------------------------
# Compile count, donation, fingerprints, devices
# ---------------------------------------------------------------------------


def _traffic(handle, y, yc, models):
    return [
        Workload(kind="cv", dataset=handle, y=y),
        Workload(kind="cv", dataset=handle, y=np.stack([y, -y, y], axis=1)),
        Workload(kind="cv", dataset=handle, y=y, estimator="ridge"),
        Workload(kind="cv", dataset=handle, y=yc, estimator="multiclass", num_classes=C),
        Workload(kind="permutation", dataset=handle, y=y, n_perm=7, seed=3),
        Workload(kind="permutation", dataset=handle, y=yc, estimator="multiclass",
                 num_classes=C, n_perm=5, seed=4),
        Workload(kind="rsa", dataset=handle, y=yc, num_classes=C, model_rdms=models,
                 n_perm=6, seed=5),
    ]


def test_compile_count_flat_after_warmup(problem):
    x, y, yc = problem
    engine = CVEngine(EngineConfig(device="cpu", buckets=(1, 4, 8)))
    handle = engine.register(torch.tensor(x), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    summary = engine.warmup(handle, tasks=("binary", "ridge", "multiclass", "permutation",
                                           "rsa"), num_classes=C, num_model_rdms=2, pin=True)
    assert summary["buckets"] == (1, 4, 8) and summary["pinned"]
    assert summary["compiles"] == engine.compile_count() > 0
    built = engine.plans_built
    models = np.stack([1.0 - np.eye(C), np.abs(np.arange(C)[:, None] - np.arange(C))])
    before = engine.compile_count()
    for _ in range(2):
        run_workloads(engine, _traffic(handle, y, yc, models))
    assert engine.compile_count() == before
    assert engine.plans_built == built == 1
    assert engine.stats()["pinned"] == 1
    # a shape outside the warm-up's buckets is one new signature, once
    run_workloads(engine, [Workload(kind="cv", dataset=handle, y=np.stack([y] * 9, axis=1))])
    run_workloads(engine, [Workload(kind="cv", dataset=handle, y=np.stack([y] * 10, axis=1))])
    assert engine.compile_count() == before + 1        # 9 and 10 share the bucket 16


def test_donate_never_touches_the_callers_batch(problem):
    x, y, _ = problem
    engine = CVEngine(EngineConfig(device="cpu", donate=True))
    _, plan = engine.plan(torch.tensor(x), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    batch = torch.tensor(np.stack([y, -y, y, -y], axis=1))   # (N, 4): an exact bucket
    kept = batch.clone()
    out = engine.eval_binary(plan, batch)
    assert torch.equal(batch, kept) and out.data_ptr() != batch.data_ptr()
    assert torch.equal(out, CVEngine(EngineConfig(device="cpu")).eval_binary(plan, kept))
    keys = {k[2] for k in engine._evals}
    engine.set_donate(False)
    engine.eval_binary(plan, batch)
    assert {k[2] for k in engine._evals} == keys | {False}   # donate stays in the key


def test_handle_traffic_never_fingerprints_x(problem, monkeypatch):
    x, y, yc = problem
    calls = []
    real = fastcv.fingerprint
    monkeypatch.setattr(fastcv, "fingerprint", lambda a, **kw: calls.append(a.shape) or real(
        a, **kw))
    engine = CVEngine(EngineConfig(device="cpu"))
    f = folds.kfold(N, K, seed=1, device="cpu")
    handle = engine.register(torch.tensor(x), f, LAM)
    assert calls == [(N, P), f.te_idx.shape, f.tr_idx.shape]      # once, at registration
    calls.clear()
    cv = [Workload(kind="cv", dataset=handle, y=y),
          Workload(kind="cv", dataset=handle, y=y, estimator="ridge"),
          Workload(kind="permutation", dataset=handle, y=y, n_perm=4)]
    for _ in range(3):
        run_workloads(engine, cv)
    assert calls == []
    spec = DatasetSpec(x, f, LAM)                                  # inline: hashed per batch
    for _ in range(2):
        run_workloads(engine, [Workload(kind="cv", dataset=spec, y=y)] * 2)
    assert [s for s in calls if s == (N, P)] == [(N, P)] * 2


@pytest.mark.parametrize("given", ["tensor", "numpy"])
def test_registered_handle_owns_its_data(problem, given):
    # the handle's key names the bytes registered: a caller that changes its
    # X and folds in place afterwards changes nothing the engine rebuilds
    x = problem[0].copy()
    xs = torch.tensor(x) if given == "tensor" else x     # numpy: as_tensor shares memory
    f = folds.kfold(N, K, seed=1, device="cpu")
    engine = CVEngine(EngineConfig(device="cpu"))
    handle = engine.register(xs, f, LAM)
    _, before = engine.resolve(handle)
    xs[:] = 2.0 * xs[:] + 1.0
    f.te_idx[:] = f.te_idx.flip(0)
    assert engine.evict(handle)
    _, rebuilt = engine.resolve(handle)
    assert engine.plans_built == 2
    _, want = CVEngine(EngineConfig(device="cpu")).plan(
        torch.tensor(problem[0]), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    for leaf in ("h", "te_idx", "tr_idx", "h_tr_te"):
        assert torch.equal(getattr(rebuilt, leaf), getattr(want, leaf))
        assert torch.equal(getattr(rebuilt, leaf), getattr(before, leaf))


def test_default_engine_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CVEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CVEngine(EngineConfig(plan_store="unused"))
    with pytest.raises(ValueError):
        EngineConfig(gram_impl="xla")


def test_engine_moves_inputs_to_its_device(problem):
    """Plans, results and everything the engine makes live on its device;
    an explicit fused=False keeps the composite, fused=True the kernels'
    plain versions here (the same values to f64 rounding)."""
    x, y, _ = problem
    results = {}
    for fused in (None, False, True):
        engine = CVEngine(EngineConfig(device="cpu", fused=fused))
        _, plan = engine.plan(x, (np.asarray(folds.kfold(N, K, seed=1, device="cpu").te_idx),
                                  np.asarray(folds.kfold(N, K, seed=1, device="cpu").tr_idx)),
                              LAM)
        assert plan.h.device.type == "cpu" and plan.te_idx.dtype == torch.int32
        results[fused] = engine.eval_binary(plan, y)
    assert torch.equal(results[None], results[False])
    _close(results[True], results[False])


# ---------------------------------------------------------------------------
# Versioned datasets against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["append", "retire", "window"])
@pytest.mark.parametrize("p", [P, 20])
def test_updates_match_reference(problem, op, p):
    x0, y, _ = problem
    rng = np.random.default_rng(11)
    x = np.concatenate([x0[:, :p], rng.normal(size=(K, p))])
    xb, xa = x[:N], x[N:]
    drop = np.arange(K) * (N // K)
    port = CVEngine(EngineConfig(device="cpu"))
    ref = RefEngine(RefConfig())
    h = port.register(torch.tensor(xb), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    rh = ref.register(jnp.asarray(xb), ref_folds.kfold(N, K, seed=1), LAM)
    kw = {"append": dict(x_new=xa), "retire": dict(drop_idx=drop),
          "window": dict(x_new=xa, drop_idx=drop)}[op]
    if op == "retire":
        te = np.asarray(folds.kfold(N, K, seed=1, device="cpu").te_idx)
        kw = dict(drop_idx=te[:, 0])               # one test row per fold: folds stay rectangular
    h2 = port.update_dataset(h, **{k: (torch.tensor(v) if k == "x_new" else v)
                                   for k, v in kw.items()})
    rh2 = ref.update_dataset(rh, **{k: jnp.asarray(v) for k, v in kw.items()})
    assert (h2.version, h2.n, h2.n_appended, h2.mode) == (rh2.version, rh2.n, rh2.n_appended,
                                                          rh2.mode)
    assert port.plans_updated == 1
    assert port.plans_built == (1 if p >= N else 2)       # primal updates rebuild
    rec, rrec = port.dataset_record(h2), ref.dataset_record(rh2)
    np.testing.assert_array_equal(rec.folds.te_idx.numpy(), np.asarray(rrec.folds.te_idx))
    _close(rec.x, rrec.x, 0.0)
    y2 = np.where(np.arange(h2.n) % 2 == 0, -1.0, 1.0)
    (got,) = run_workloads(port, [Workload(kind="cv", dataset=h2, y=y2)])
    _, rplan = ref.resolve(rh2)
    _close(got.values, ref.eval_binary(rplan, jnp.asarray(y2)), 1e-8)
    text = port.metrics.render_prometheus()
    assert f'plan_updates_total{{op="{op}"}} 1' in text


def test_release_waits_for_in_flight_versions(problem):
    x, y, _ = problem
    engine = CVEngine(EngineConfig(device="cpu"))
    h = engine.register(torch.tensor(x), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    run_workloads(engine, [Workload(kind="cv", dataset=h, y=y)])
    engine.retain_version(h.key)
    assert not engine.release(h)                      # deferred: a batch pins it
    assert engine.dataset_record(h).retired
    engine.release_version(h.key)
    with pytest.raises(KeyError):
        engine.dataset_record(h)
    assert len(engine.cache) == 0 and engine.stats()["datasets_registered"] == 0


def test_concurrent_batches_lose_no_update(problem):
    """Eight threads drive one engine at once (more threads than the
    cores these tests get, a short switch interval): one plan build
    (the cache's single flight), every label and request counted and
    every version pin dropped (the engine's lock)."""
    x, y, _ = problem
    engine = CVEngine(EngineConfig(device="cpu"))
    handle = engine.register(torch.tensor(x), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    work = [Workload(kind="cv", dataset=handle, y=np.stack([y, -y, y], axis=1))]
    errors = []

    def drive():
        try:
            for _ in range(5):
                run_workloads(engine, work)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert engine.plans_built == 1
    # each coalesced batch reaches the engine padded to its bucket (4), as
    # in the reference, and counts its 4 columns
    assert engine.labels_evaluated == 8 * 5 * bucket_size(3)
    assert engine.dataset_record(handle).refs == 0
    assert engine.dataset_record(handle).served == 8 * 5
