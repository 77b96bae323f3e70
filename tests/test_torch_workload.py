"""repro_torch.serve.workload on the CPU, against the reference's run_workloads.

Every ``kind`` of workload goes through the port's ``run_workloads`` and
the reference's on the same f64 inputs (``device="cpu"``), and the
responses agree to ≤ 1e-9 relative (1e-12 for metrics and p-values on
shared draws). The permutation draws of the two packages differ
(``jax.random`` against this package's generator), so a permutation
workload's null is held to the port's own ``null_*`` on
``permutation_indices(seed, …)`` and its observed value to the
reference's. Beside them: the schema-1 upgrade, validation errors equal
to the reference's, the wire format across packages in both directions,
streaming equal to the monolithic run, ``TrafficLog`` record / replay
with the compile count flat, per-workload errors, and registration of a
new estimator.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folds as ref_folds
from repro.serve import CVEngine as RefEngine
from repro.serve import DatasetSpec as RefSpec
from repro.serve import EngineConfig as RefConfig
from repro.serve import TrafficLog as RefTrafficLog
from repro.serve import Workload as RefWorkload
from repro.serve import run_workloads as ref_run
from repro_torch.core import fastcv, folds
from repro_torch.core import permutation as perm_lib
from repro_torch.serve import (CVEngine, DatasetHandle, DatasetSpec, EngineConfig,
                               LeastSquaresSpec, TrafficLog, Workload, bucket_size, estimators,
                               register_estimator, run_workloads, stream_workload)
from repro_torch.serve import workload as workload_mod

N, P, K, LAM, C = 48, 110, 4, 1.0, 3
TOL = 1e-9
TOL_SHARED = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, P))
    yc = (np.arange(N) % C).astype(np.int64)
    y = np.where(yc == 1, 1.0, -1.0)
    x[:, :6] += 0.9 * yc[:, None]
    xs = np.stack([x[:, 3 * q:3 * q + 12] for q in range(3)])      # a (3, N, 12) grid
    models = np.stack([1.0 - np.eye(C), np.abs(np.arange(C)[:, None] - np.arange(C))])
    f = folds.kfold(N, K, seed=2, device="cpu")
    return {"x": x, "y": y, "yc": yc, "xs": xs, "models": models, "folds": f,
            "pair": (f.te_idx.numpy(), f.tr_idx.numpy())}


@pytest.fixture(scope="module")
def sides(data):
    """(port engine, its handle, reference engine, its handle)."""
    port = CVEngine(EngineConfig(device="cpu"))
    ref = RefEngine(RefConfig())
    handle = port.register(torch.tensor(data["x"]), data["folds"], LAM)
    ref_handle = ref.register(jnp.asarray(data["x"]), ref_folds.kfold(N, K, seed=2), LAM)
    assert handle.key == ref_handle.key
    return port, handle, ref, ref_handle


def _cases(d):
    """name -> (W, handle, spec) -> workload, one per kind and option."""
    y, yc, x = d["y"], d["yc"], d["x"]
    return {
        "cv_binary": lambda W, h, S: W(kind="cv", dataset=h, y=y),
        "cv_binary_batch": lambda W, h, S: W(kind="cv", dataset=h,
                                             y=np.stack([y, -y, np.roll(y, 3)], 1)),
        "cv_binary_no_adjust": lambda W, h, S: W(kind="cv", dataset=h, y=y, adjust_bias=False),
        "cv_ridge": lambda W, h, S: W(kind="cv", dataset=h, y=y + 0.1 * yc, estimator="ridge"),
        "cv_ridge_multi": lambda W, h, S: W(kind="cv", dataset=h, y=np.stack([y, yc * 1.0], 1),
                                            estimator="ridge_multi"),
        "cv_multiclass": lambda W, h, S: W(kind="cv", dataset=h, y=yc, estimator="multiclass",
                                           num_classes=C),
        "cv_inline_spec": lambda W, h, S: W(kind="cv", dataset=S(x, d["pair"], LAM), y=y),
        "permutation_binary": lambda W, h, S: W(kind="permutation", dataset=h, y=y, n_perm=9,
                                                seed=4),
        "permutation_auc": lambda W, h, S: W(kind="permutation", dataset=h, y=y, n_perm=5,
                                             metric="auc", seed=5),
        "permutation_multiclass": lambda W, h, S: W(kind="permutation", dataset=h, y=yc,
                                                    estimator="multiclass", num_classes=C,
                                                    n_perm=6, seed=6),
        "rsa_accuracy": lambda W, h, S: W(kind="rsa", dataset=h, y=yc, num_classes=C,
                                          model_rdms=d["models"], n_perm=7, seed=7),
        "rsa_contrast": lambda W, h, S: W(kind="rsa", dataset=h, y=yc, num_classes=C,
                                          dissimilarity="contrast", adjust_bias=False,
                                          model_rdms=d["models"], comparison="pearson"),
        "rsa_confusion": lambda W, h, S: W(kind="rsa", dataset=h, y=yc, num_classes=C,
                                           contrast="multiclass"),
        "tune": lambda W, h, S: W(kind="tune", x=x, y=y, lambdas=np.asarray([0.3, 3.0, 30.0])),
        "tune_error": lambda W, h, S: W(kind="tune", x=x, y=y, criterion="error",
                                        lambdas=np.asarray([0.3, 3.0, 30.0])),
        "grid": lambda W, h, S: W(kind="grid", dataset=h, xs=d["xs"], y=y),
    }


CASES = list(_cases({k: None for k in ("y", "yc", "x", "xs", "models", "pair")}))


@pytest.mark.parametrize("case", CASES)
def test_every_kind_matches_the_reference(data, sides, case):
    port, handle, ref, ref_handle = sides
    build = _cases(data)[case]
    (got,) = run_workloads(port, [build(Workload, handle, DatasetSpec)])
    (want,) = ref_run(ref, [build(RefWorkload, ref_handle, RefSpec)])
    assert type(got).__name__ == type(want).__name__
    if case.startswith("cv"):
        assert got.plan_key == want.plan_key and got.task == want.task
        if case == "cv_multiclass":
            np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
        else:
            _close(got.values, want.values)
        _close(got.y_te, want.y_te, 0.0)
        _close(got.score, want.score)
    elif case.startswith("permutation"):
        _close(got.observed, want.observed, TOL_SHARED)
        w = build(Workload, handle, DatasetSpec)
        _, plan = port.resolve(handle)
        perms = perm_lib.permutation_indices(w.seed, N, w.n_perm, device="cpu")
        if w.estimator == "multiclass":
            null = port.null_multiclass(plan, torch.tensor(data["yc"]), perms, num_classes=C)
        else:
            null = port.null_binary(plan, torch.tensor(data["y"]), perms, metric=w.metric)
        assert torch.equal(got.null, null) and got.null.shape == (w.n_perm,)
        assert float(got.p) == float(perm_lib.p_value(got.observed, null))
    elif case.startswith("rsa"):
        _close(got.rdm, want.rdm)
        if want.pair_values is not None:
            _close(got.pair_values, want.pair_values)
        if want.model_scores is not None:
            _close(got.model_scores, want.model_scores)
        if want.null is not None:                      # the port's null on its own draws
            perms = perm_lib.permutation_indices(7, C, bucket_size(7), device="cpu")
            null = port.null_rdm_scores(got.rdm, torch.tensor(data["models"]), perms)[:, :7]
            assert torch.equal(got.null, null)
            p = (1.0 + (null >= got.model_scores[:, None]).sum(1)) / 8.0
            _close(got.p, p, TOL_SHARED)
    elif case.startswith("tune"):
        _close(got.result.scores, want.result.scores)
        _close(got.result.best_lambda, want.result.best_lambda, 0.0)
    else:
        _close(got.accuracies, want.accuracies, TOL_SHARED)


def test_rsa_nulls_match_on_shared_draws(data, sides):
    """The model-score null and its p-values of the same RDM, on explicit
    draws given to both engines (the draws of the two packages differ)."""
    port, handle, ref, ref_handle = sides
    w = _cases(data)["rsa_accuracy"]
    (got,) = run_workloads(port, [w(Workload, handle, DatasetSpec)])
    perms = np.stack([np.random.default_rng(s).permutation(C) for s in range(12)])
    models = data["models"]
    mine = port.null_rdm_scores(got.rdm, torch.tensor(models), torch.tensor(perms))
    theirs = ref.null_rdm_scores(jnp.asarray(got.rdm.numpy()), jnp.asarray(models),
                                 jnp.asarray(perms, jnp.int32))
    _close(mine, theirs, TOL_SHARED)
    scores = got.model_scores
    _close(workload_mod._rdm_p_value(scores, mine),
           (1.0 + np.sum(np.asarray(theirs) >= scores.numpy()[:, None], 1)) / 13.0, TOL_SHARED)


def test_update_kind_matches_the_reference(data):
    x, y = data["x"], data["y"]
    rng = np.random.default_rng(9)
    x_new = rng.normal(size=(2 * K, P))
    port, ref = CVEngine(EngineConfig(device="cpu")), RefEngine(RefConfig())
    h = port.register(torch.tensor(x), data["folds"], LAM)
    rh = ref.register(jnp.asarray(x), ref_folds.kfold(N, K, seed=2), LAM)
    # an append of K rows; then two members that coalesce into one window step
    steps = [lambda W, hh: [W(kind="update", dataset=hh, x=x_new[:K])],
             lambda W, hh: [W(kind="update", dataset=hh, x=x_new[K:K + 2]),
                            W(kind="update", dataset=hh, drop_idx=np.asarray([0, 5]))]]
    for step in steps:
        got, want = run_workloads(port, step(Workload, h)), ref_run(ref, step(RefWorkload, rh))
        for a, b in zip(got, want):
            assert (a.version, a.appended, a.dropped, a.rank) == (b.version, b.appended,
                                                                  b.dropped, b.rank)
            assert (a.handle.n, a.handle.n_appended) == (b.handle.n, b.handle.n_appended)
        assert all(a.handle == got[0].handle for a in got)
        h, rh = got[0].handle, want[0].handle
    assert port.plans_updated == 2 and h.version == 2 and h.n == N + K
    y2 = np.where(np.arange(h.n) % 2 == 0, -1.0, 1.0)
    (a,) = run_workloads(port, [Workload(kind="cv", dataset=h, y=y2)])
    (b,) = ref_run(ref, [RefWorkload(kind="cv", dataset=rh, y=y2)])
    _close(a.values, b.values, 1e-8)


# ---------------------------------------------------------------------------
# Schema, validation, wire format
# ---------------------------------------------------------------------------


def _wire_workloads(data, handle, W, S):
    y, yc = data["y"], data["yc"]
    return [
        W(kind="cv", dataset=handle, y=y),
        W(kind="cv", dataset=S(data["x"][:, :20], data["pair"], LAM, "primal"), y=y),
        W(kind="permutation", dataset=handle, y=yc, estimator="multiclass", num_classes=C,
          n_perm=11, seed=3),
        W(kind="rsa", dataset=handle, y=yc, num_classes=C, model_rdms=data["models"],
          comparison="kendall", n_perm=4),
        W(kind="tune", x=data["x"][:, :8], y=y, lambdas=np.asarray([1.0, 2.0]),
          criterion="error"),
        W(kind="grid", dataset=handle, xs=data["xs"], y=y),
        W(kind="update", dataset=handle, x=data["x"][:K], drop_idx=np.asarray([1, 2],
                                                                               np.int32)),
    ]


def test_wire_dicts_round_trip_across_packages(data, sides):
    _, handle, _, ref_handle = sides
    for theirs in _wire_workloads(data, ref_handle, RefWorkload, RefSpec):
        d = json.loads(json.dumps(theirs.to_dict()))
        mine = Workload.from_dict(d)
        assert mine.to_dict() == d
        assert isinstance(mine.y, np.ndarray) or mine.y is None
    for mine in _wire_workloads(data, handle, Workload, DatasetSpec):
        d = json.loads(json.dumps(mine.to_dict()))
        assert RefWorkload.from_dict(d).to_dict() == d
        assert Workload.from_dict(d).to_dict() == d
    back = Workload.from_dict(Workload(kind="cv", dataset=handle, y=data["y"]).to_dict())
    assert isinstance(back.dataset, DatasetHandle) and back.dataset == handle


def test_schema_1_dicts_are_upgraded(data, sides):
    port, handle, _, _ = sides
    d = Workload(kind="cv", dataset=handle, y=data["y"]).to_dict()
    d["schema"] = 1
    del d["drop_idx"]
    w = Workload.from_dict(d)
    assert w.to_dict()["schema"] == 2 and w.drop_idx is None
    (a,) = run_workloads(port, [w])
    (b,) = run_workloads(port, [Workload(kind="cv", dataset=handle, y=data["y"])])
    assert torch.equal(a.values, b.values)
    with pytest.raises(ValueError, match="schema version"):
        Workload.from_dict({"schema": 99, "kind": "cv"})


def _bad(d, handle):
    y, yc, x = d["y"], d["yc"], d["x"]
    spec = (x, d["pair"], LAM)
    return [
        dict(kind="nonsense", dataset=spec, y=y),
        dict(kind="cv", dataset=spec, y=y, estimator="nonsense"),
        dict(kind="cv", dataset=spec, y=y * 2.0),
        dict(kind="cv", dataset=spec, y=y[:5]),
        dict(kind="cv", dataset=spec, y=yc + 5, estimator="multiclass", num_classes=C),
        dict(kind="cv", dataset=spec, y=y, estimator="multiclass", num_classes=C),
        dict(kind="cv", dataset=spec, y=y, estimator="ridge_multi"),
        dict(kind="permutation", dataset=spec, y=y, n_perm=0),
        dict(kind="permutation", dataset=spec, y=np.stack([y, -y], 1), n_perm=4),
        dict(kind="permutation", dataset=spec, y=y, n_perm=4, metric="nonsense"),
        dict(kind="permutation", dataset=spec, y=y, n_perm=4, estimator="ridge"),
        dict(kind="rsa", dataset=spec, y=yc, num_classes=0),
        dict(kind="rsa", dataset=spec, y=yc, num_classes=C, model_rdms=np.ones((2, 4, 4))),
        dict(kind="rsa", dataset=spec, y=yc, num_classes=C, comparison="nonsense"),
        dict(kind="rsa", dataset=spec, y=y, num_classes=C),
        dict(kind="cv", y=y),
        dict(kind="cv", dataset=object(), y=y),
        dict(kind="tune", x=x, y=y, criterion="nonsense"),
        dict(kind="tune", x=x, y=y[:3]),
        dict(kind="grid", dataset=spec, y=y, xs=x),
        dict(kind="update", dataset=spec, x=x[:2]),
        dict(kind="update", dataset=handle),
        dict(kind="update", dataset=handle, x=x[:2, :5]),
        dict(kind="update", dataset=handle, drop_idx=np.asarray([0, 0])),
        dict(kind="update", dataset=handle, drop_idx=np.asarray([N + 1])),
        dict(kind="update", dataset=handle, drop_idx=np.asarray([0.5])),
    ]


def test_validation_errors_equal_the_reference(data, sides):
    _, handle, _, ref_handle = sides
    mine, theirs = _bad(data, handle), _bad(data, ref_handle)
    for kw, rkw in zip(mine, theirs):
        def make(W, S, kw):
            kw = dict(kw)
            if isinstance(kw.get("dataset"), tuple):
                kw["dataset"] = S(*kw["dataset"])
            return W(**kw)
        with pytest.raises((ValueError, TypeError)) as err:
            make(Workload, DatasetSpec, kw)
        with pytest.raises((ValueError, TypeError)) as ref_err:
            make(RefWorkload, RefSpec, rkw)
        assert type(err.value) is type(ref_err.value)
        assert str(err.value) == str(ref_err.value), kw["kind"]


def test_errors_are_returned_per_workload(data, sides):
    port, handle, _, _ = sides
    stranger = DatasetHandle(key=("0" * 32,) + handle.key[1:], n=N, p=P)
    out = run_workloads(port, [Workload(kind="cv", dataset=stranger, y=data["y"]),
                               Workload(kind="cv", dataset=handle, y=data["y"])],
                        return_errors=True)
    assert isinstance(out[0], KeyError) and out[1].values.shape == (K, N // K)
    with pytest.raises(KeyError, match="not registered"):
        run_workloads(port, [Workload(kind="cv", dataset=stranger, y=data["y"])])
    assert port.dataset_record(handle).refs == 0         # pins dropped on the failure


# ---------------------------------------------------------------------------
# Streaming, traffic logs, registration
# ---------------------------------------------------------------------------


def test_streaming_equals_monolithic(data, sides):
    port, handle, _, _ = sides
    y = data["y"]
    w = Workload(kind="permutation", dataset=handle, y=y, n_perm=20, seed=4)
    events = list(stream_workload(port, w, chunk=8))
    assert [e.kind for e in events[:2]] == ["plan", "observed"] and events[-1].kind == "done"
    chunks = [e.payload for e in events if e.kind == "null"]
    assert [len(c) for c in chunks] == [8, 8, 4] and events[-2].done == 20
    (mono,) = run_workloads(port, [w])
    final = events[-1].payload
    assert torch.equal(torch.cat(chunks), mono.null) and torch.equal(final.null, mono.null)
    assert float(final.p) == float(mono.p) and float(final.observed) == float(mono.observed)

    r = Workload(kind="rsa", dataset=handle, y=data["yc"], num_classes=C,
                 model_rdms=data["models"], n_perm=10, seed=2)
    events = list(stream_workload(port, r, chunk=4))
    assert [e.kind for e in events][:3] == ["plan", "rdm", "scores"]
    (mono,) = run_workloads(port, [r])
    final = events[-1].payload
    assert torch.equal(final.null, mono.null) and torch.equal(final.p, mono.p)
    assert torch.equal(final.rdm, mono.rdm)

    (done,) = list(stream_workload(port, Workload(kind="cv", dataset=handle, y=y)))
    assert done.kind == "done" and done.payload.values.shape == (K, N // K)


def test_streamed_update_advances_in_increments(data):
    engine = CVEngine(EngineConfig(device="cpu"))
    h = engine.register(torch.tensor(data["x"]), data["folds"], LAM)
    rows = np.random.default_rng(3).normal(size=(3 * K + 2, P))
    w = Workload(kind="update", dataset=h, x=rows, drop_idx=np.asarray([3, 7]))
    events = list(stream_workload(engine, w, chunk=K))
    updates = [e.payload for e in events if e.kind == "update"]
    assert [(u["appended"], u["dropped"]) for u in updates] == [(2, 2), (K, 0), (K, 0), (K, 0)]
    final = events[-1].payload
    assert final.version == 4 and final.handle.n == N + 3 * K
    assert len(engine.datasets()) == 2                  # base and final versions survive


def test_traffic_log_records_what_the_reference_records_and_replays_warm(data, sides, tmp_path):
    _, handle, _, ref_handle = sides
    y, yc = data["y"], data["yc"]
    traffic = lambda W, h: [
        W(kind="cv", dataset=h, y=y), W(kind="cv", dataset=h, y=y, adjust_bias=False),
        W(kind="cv", dataset=h, y=np.stack([y] * 3, 1), estimator="ridge"),
        W(kind="cv", dataset=h, y=yc, estimator="multiclass", num_classes=C),
        W(kind="permutation", dataset=h, y=y, n_perm=12, seed=0),
        W(kind="rsa", dataset=h, y=yc, num_classes=C, model_rdms=data["models"], n_perm=5),
        W(kind="rsa", dataset=h, y=yc, num_classes=C, contrast="multiclass"),
        W(kind="tune", x=data["x"], y=y)]
    log, ref_log = TrafficLog(), RefTrafficLog()
    for w in traffic(Workload, handle):
        log.record(w, (1, 2, 4, 8, 16), stream_chunk=4)
    for w in traffic(RefWorkload, ref_handle):
        ref_log.record(w, (1, 2, 4, 8, 16), stream_chunk=4)
    assert log.to_json() == ref_log.to_json()
    path = tmp_path / "traffic.json"
    log.save(path)
    loaded = TrafficLog.load(path)
    assert loaded.entries() == log.entries()
    engine = CVEngine(EngineConfig(device="cpu", buckets=(1, 2, 4, 8, 16)))
    h = engine.register(torch.tensor(data["x"]), data["folds"], LAM)
    loaded.replay(engine, h, pin=True)
    warm, built = engine.compile_count(), engine.plans_built
    run_workloads(engine, traffic(Workload, h))
    assert engine.compile_count() == warm and engine.plans_built == built == 1
    assert engine.stats()["pinned"] == 1
    with pytest.raises(ValueError, match="schema"):
        TrafficLog.from_json('{"schema": 42, "entries": []}')


def test_a_registered_estimator_is_served_with_no_engine_change(data, sides):
    port, handle, _, _ = sides
    name = "ridge_demeaned"

    def encode(yv, dtype, opts):
        squeeze = yv.ndim == 1
        yb = (yv[:, None] if squeeze else yv).to(dtype)
        return yb - yb.mean(dim=0, keepdim=True), squeeze

    register_estimator(LeastSquaresSpec(
        name=name, layout="columns",
        make_eval=lambda opts, fused: fastcv.make_eval_cv(fused=fused),
        encode=encode, score=lambda values, y_te, opts: ((values - y_te) ** 2).mean(),
        eval_key="ridge"))
    try:
        assert name in estimators()
        with pytest.raises(ValueError, match="already registered"):
            register_estimator(LeastSquaresSpec(name=name, layout="columns",
                                                make_eval=lambda *a: None))
        y = data["y"]
        run_workloads(port, [Workload(kind="cv", dataset=handle, y=y, estimator="ridge")])
        warm = port.compile_count()
        (resp,) = run_workloads(port, [Workload(kind="cv", dataset=handle, y=y,
                                                estimator=name)])
        assert port.compile_count() == warm               # shares the ridge evaluator
        _, plan = port.resolve(handle)
        assert torch.equal(resp.values, port.eval_ridge(plan, torch.tensor(y - y.mean())))
    finally:
        del workload_mod._ESTIMATORS[name]


def test_labels_evaluated_counts_requested_draws(data, sides):
    port, handle, _, _ = sides
    _, plan = port.resolve(handle)
    before = port.labels_evaluated
    port.permutation_binary(plan, torch.tensor(data["y"]), 20, 0)
    assert port.labels_evaluated - before == 20          # not the bucket's 32


# ---------------------------------------------------------------------------
# The reference's registry and RDM-memo contracts (tests/test_workload.py)
# ---------------------------------------------------------------------------


def _engine():
    return CVEngine(EngineConfig(device="cpu"))


def test_register_is_idempotent_and_introspectable(data):
    engine = _engine()
    h1 = engine.register(data["x"], data["folds"], LAM)
    h2 = engine.register(data["x"], data["folds"], LAM)
    assert h1 == h2
    assert h1.n == N and h1.p == P
    (info,) = engine.datasets()
    assert info["resident"] is False and info["served"] == 0
    run_workloads(engine, [Workload(kind="cv", dataset=h1, y=data["y"])])
    (info,) = engine.datasets()
    assert info["resident"] is True and info["served"] == 1 and info["nbytes"] > 0


def test_handle_pin_warmup_evict(data):
    engine = _engine()
    h = engine.register(data["x"], data["folds"], LAM)
    info = engine.warmup(h, tasks=("binary",), buckets=(1,), pin=True)
    assert info["pinned"]
    assert engine.datasets()[0]["pinned"] is True
    assert engine.unpin(h)
    assert engine.evict(h)
    assert engine.datasets()[0]["resident"] is False
    # a handle workload transparently rebuilds the evicted plan
    built = engine.plans_built
    (resp,) = run_workloads(engine, [Workload(kind="cv", dataset=h, y=data["y"])])
    assert type(resp).__name__ == "CVResponse"
    assert engine.plans_built == built + 1
    engine.evict(h, deregister=True)
    with pytest.raises(KeyError, match="not registered"):
        run_workloads(engine, [Workload(kind="cv", dataset=h, y=data["y"])])


def test_unregistered_handle_fails_clearly(data):
    h = _engine().register(data["x"], data["folds"], LAM)
    with pytest.raises(KeyError, match="not registered"):
        run_workloads(_engine(), [Workload(kind="cv", dataset=h, y=data["y"])])


def test_rdm_memo_stable_across_plan_variants(data):
    """The memo must hit even when the same workload is later served from
    the cached *superset* (train-block) plan instead of the train-free one."""
    engine = _engine()
    spec = DatasetSpec(data["x"], folds.stratified_kfold(data["yc"], K, seed=0, device="cpu"),
                       LAM)
    w = Workload(kind="rsa", dataset=spec, y=data["yc"], num_classes=C, adjust_bias=False)
    run_workloads(engine, [w])  # builds the with_train_block=False plan
    run_workloads(engine, [Workload(kind="cv", dataset=spec, y=data["y"])])  # superset resident
    run_workloads(engine, [w])  # resolves via the superset key; must still hit
    assert engine.stats()["rdm_hits"] == 1
    assert engine.stats()["rdm_entries"] == 1


def test_rdm_memo_streaming_and_batch_share_entries(data):
    engine = _engine()
    spec = DatasetSpec(data["x"], folds.stratified_kfold(data["yc"], K, seed=0, device="cpu"),
                       LAM)
    w = Workload(kind="rsa", dataset=spec, y=data["yc"], num_classes=C)
    (batch,) = run_workloads(engine, [w])
    events = list(stream_workload(engine, w))
    assert engine.stats()["rdm_hits"] == 1  # the stream reused the memo
    assert torch.equal(events[-1].payload.rdm, batch.rdm)
