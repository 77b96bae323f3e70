"""repro_torch.serve.store on the CPU, against the reference's PlanStore.

A plan saved by either package's store is loaded and served by the other
with every leaf bit for bit equal (the layout, manifest and entry ids are
shared; ``plan_key`` is equal for the same arrays); damage — a flipped
value, a missing leaf, a garbled or version-skewed manifest — quarantines
the entry and degrades to a rebuild, never an exception; byte-budget GC
spares protected keys; an engine over a saved store warm-boots with zero
plan builds and bit-identical results.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastcv as ref_fastcv
from repro.core import folds as ref_folds
from repro.serve import CVEngine as RefEngine
from repro.serve import EngineConfig as RefConfig
from repro.serve import PlanStore as RefStore
from repro.serve import Workload as RefWorkload
from repro.serve import run_workloads as ref_run
from repro_torch.core import fastcv, folds
from repro_torch.serve import CVEngine, EngineConfig, PlanStore, Workload, run_workloads
from repro_torch.serve.store import _MANIFEST, SCHEMA_VERSION

N, P, K, LAM = 32, 72, 4, 1.0


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, P))
    y = np.where(np.arange(N) % 2 == 0, -1.0, 1.0)
    yc = (np.arange(N) % 3).astype(np.int64)
    return x, y, yc


def _port_plan(x, seed=1, train=True):
    f = folds.kfold(len(x), K, seed=seed, device="cpu")
    xt = torch.tensor(x)
    return (fastcv.plan_key(xt, f, LAM, "auto", train),
            fastcv.prepare(xt, f, LAM, with_train_block=train))


def _ref_plan(x, seed=1, train=True):
    f = ref_folds.kfold(len(x), K, seed=seed)
    return (ref_fastcv.plan_key(jnp.asarray(x), f, LAM, "auto", train),
            ref_fastcv.prepare(jnp.asarray(x), f, LAM, with_train_block=train))


def _same_leaves(got, want):
    for name in fastcv.PLAN_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("train", [True, False])
def test_reference_store_is_read_by_the_port(problem, tmp_path, train):
    x = problem[0]
    key, plan = _ref_plan(x, train=train)
    assert _port_plan(x, train=train)[0] == key        # one key names one entry in both
    assert RefStore(tmp_path).save(key, plan)
    store = PlanStore(tmp_path, device="cpu")
    assert key in store and store.keys() == [key]
    got = store.load(key)
    assert isinstance(got, fastcv.CVPlan) and got.h.device.type == "cpu"
    _same_leaves(got, plan)
    assert store.stats.hits == 1 and store.stats.quarantined == 0


@pytest.mark.parametrize("train", [True, False])
def test_port_store_is_read_by_the_reference(problem, tmp_path, train):
    x = problem[0]
    key, plan = _port_plan(x, train=train)
    store = PlanStore(tmp_path, device="cpu")
    assert store.save(key, plan) and not store.save(key, plan)   # content-addressed
    assert store.stats.writes == 1 and store.stats.bytes_in_store == store.total_bytes()
    got = RefStore(tmp_path).load(key)
    assert got is not None
    _same_leaves(got, plan)
    manifest = json.loads((store.path_for(key) / _MANIFEST).read_text())
    assert manifest["schema"] == SCHEMA_VERSION and tuple(manifest["plan_key"]) == key


def _close(got, want, tol=1e-9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= tol * max(float(np.max(np.abs(want))), 1e-30)


def test_engines_serve_each_others_stores(problem, tmp_path):
    """A reference engine saves its plan; a port engine on that directory
    builds nothing and serves what a port engine that built the plan
    serves (to f64 rounding: the plans come from two packages). A port
    engine's saved plan warm-boots another port engine bit for bit, and
    a reference engine with zero builds."""
    x, y, yc = problem
    ws = lambda W, h: [W(kind="cv", dataset=h, y=y),
                       W(kind="cv", dataset=h, y=y, estimator="ridge"),
                       W(kind="cv", dataset=h, y=yc, estimator="multiclass", num_classes=3)]
    port_folds = lambda: folds.kfold(N, K, seed=1, device="cpu")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"

    writer = CVEngine(EngineConfig(device="cpu", plan_store=str(port_dir), save_plans=True))
    want = run_workloads(writer, ws(Workload, writer.register(torch.tensor(x), port_folds(),
                                                               LAM)))
    writer.flush_store()
    assert writer.stats()["store_writes"] == 1 and writer.plans_built == 1
    warm = CVEngine(EngineConfig(device="cpu", plan_store=str(port_dir)))
    got = run_workloads(warm, ws(Workload, warm.register(torch.tensor(x), port_folds(), LAM)))
    assert warm.plans_built == 0 and warm.stats()["store_hits"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.values, b.values)

    ref = RefEngine(RefConfig(plan_store=str(ref_dir), save_plans=True))
    ref_run(ref, ws(RefWorkload, ref.register(jnp.asarray(x), ref_folds.kfold(N, K, seed=1),
                                               LAM)))
    ref.flush_store()
    port = CVEngine(EngineConfig(device="cpu", plan_store=str(ref_dir)))
    got = run_workloads(port, ws(Workload, port.register(torch.tensor(x), port_folds(), LAM)))
    assert port.plans_built == 0 and port.store.stats.hits == 1
    for a, b in zip(got[:2], want[:2]):
        _close(a.values, b.values)
    assert torch.equal(got[2].values, want[2].values)

    reader = RefEngine(RefConfig(plan_store=str(port_dir)))
    ref_run(reader, ws(RefWorkload, reader.register(jnp.asarray(x),
                                                     ref_folds.kfold(N, K, seed=1), LAM)))
    assert reader.plans_built == 0 and reader.store.stats.hits == 1


def _saved(tmp_path, x):
    key, plan = _port_plan(x)
    store = PlanStore(tmp_path, device="cpu")
    store.save(key, plan)
    return store, key


def _flip(path):
    arr = np.load(path)
    arr.flat[0] += 1e-9                  # same shape and dtype, other content
    np.save(path, arr)


@pytest.mark.parametrize("damage", [
    "flipped", "truncated", "missing_leaf", "garbled_manifest", "schema", "wrong_key"])
def test_damaged_entry_is_quarantined(problem, tmp_path, damage):
    store, key = _saved(tmp_path, problem[0])
    entry = store.path_for(key)
    if damage == "flipped":
        _flip(entry / "h.npy")
    elif damage == "truncated":
        raw = (entry / "chol_ih.npy").read_bytes()
        (entry / "chol_ih.npy").write_bytes(raw[: len(raw) // 2])
    elif damage == "missing_leaf":
        (entry / "te_idx.npy").unlink()
    elif damage == "garbled_manifest":
        (entry / _MANIFEST).write_text("{ not json")
    else:
        manifest = json.loads((entry / _MANIFEST).read_text())
        if damage == "schema":
            manifest["schema"] = SCHEMA_VERSION + 1
        else:
            manifest["plan_key"][3] = 2.0 * LAM
        (entry / _MANIFEST).write_text(json.dumps(manifest))
    assert store.load(key) is None
    assert store.stats.quarantined == 1 and store.stats.misses == 1
    assert not entry.exists() and len(list((tmp_path / "quarantine").iterdir())) == 1
    assert store.load(key) is None and store.stats.quarantined == 1   # a clean miss now
    # the reference reads the same damage the same way
    ref_store, ref_key = _saved(tmp_path / "again", problem[0])
    _flip(ref_store.path_for(ref_key) / "h.npy")
    assert RefStore(tmp_path / "again").load(ref_key) is None


def test_damaged_store_degrades_to_a_rebuild(problem, tmp_path):
    x, y, _ = problem
    store, key = _saved(tmp_path, x)
    (store.path_for(key) / "h.npy").write_bytes(b"garbage")
    engine = CVEngine(EngineConfig(device="cpu", plan_store=str(tmp_path)))
    handle = engine.register(torch.tensor(x), folds.kfold(N, K, seed=1, device="cpu"), LAM)
    (resp,) = run_workloads(engine, [Workload(kind="cv", dataset=handle, y=y)])
    assert torch.isfinite(resp.values).all()
    assert engine.plans_built == 1 and engine.store.stats.quarantined == 1


def test_gc_budget_protect_and_remove(tmp_path):
    rng = np.random.default_rng(5)
    entries = [_port_plan(rng.normal(size=(N, P)), seed=i) for i in range(3)]
    store = PlanStore(tmp_path, byte_budget=1 << 40, device="cpu")
    for key, plan in entries:
        store.save(key, plan)
    per_entry = store.total_bytes() // 3
    store.stats.byte_budget = int(per_entry * 1.5)
    assert store.gc(protect=[entries[0][0]]) == 2       # the oldest is protected
    assert store.load(entries[0][0]) is not None
    assert store.load(entries[1][0]) is None and store.load(entries[2][0]) is None
    assert store.remove(entries[0][0]) and not store.remove(entries[0][0])
    assert len(store) == 0 and store.stats.quarantined == 0
    thread = store.save_async(*entries[1])
    store.flush()
    assert not thread.is_alive() and entries[1][0] in store


def test_store_device_follows_the_device_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanStore(tmp_path)


# ---------------------------------------------------------------------------
# The reference's store contracts (tests/test_store.py), held on the port
# ---------------------------------------------------------------------------


def _distinct_plans(n_plans, seed0=10):
    """(x, folds, key, plan) of n_plans different datasets."""
    out = []
    for i in range(n_plans):
        x = torch.tensor(np.random.default_rng(seed0 + i).normal(size=(N, P)))
        f = folds.kfold(N, K, seed=i, device="cpu")
        out.append((x, f, fastcv.plan_key(x, f, LAM, "auto", True),
                    fastcv.prepare(x, f, LAM, with_train_block=True)))
    return out


def test_gc_never_evicts_memory_pinned(tmp_path):
    plans = _distinct_plans(3)
    store = PlanStore(tmp_path, byte_budget=1 << 40, device="cpu")
    for _, _, key, plan in plans:
        store.save(key, plan)
    pinned_key = plans[0][2]  # oldest AND protected
    store.stats.byte_budget = store.total_bytes() // 3  # room for ~one entry
    store.gc(protect=[pinned_key])
    assert store.load(pinned_key) is not None, "pinned entry must survive GC"
    assert store.stats.evictions == 2


def test_engine_write_behind_protects_pins(tmp_path):
    """The engine's save path shields cache-pinned keys from store GC."""
    plans = _distinct_plans(2)
    (x0, f0, key0, plan0), (x1, f1, _, _) = plans
    probe = PlanStore(tmp_path / "probe", device="cpu")
    probe.save(key0, plan0)
    entry_bytes = probe.total_bytes()
    engine = CVEngine(EngineConfig(device="cpu", plan_store=str(tmp_path / "store"),
                                   save_plans=True,
                                   store_bytes=int(entry_bytes * 1.5)))  # one fits, two don't
    h0 = engine.register(x0, f0, LAM)
    engine.resolve(h0)
    engine.pin(h0)
    engine.flush_store()
    h1 = engine.register(x1, f1, LAM)
    engine.resolve(h1)
    engine.flush_store()
    # over budget: GC ran, but the pinned (older) entry survived
    assert engine.store.load(h0.key) is not None
    assert engine.store.stats.evictions >= 1


def test_concurrent_writers_do_not_corrupt(tmp_path):
    import threading

    plans = _distinct_plans(4)
    stores = [PlanStore(tmp_path, device="cpu") for _ in range(2)]

    def hammer(store, order):
        for i in order:
            _, _, key, plan = plans[i]
            store.save(key, plan)

    threads = [threading.Thread(target=hammer, args=(stores[0], [0, 1, 2, 3])),
               threading.Thread(target=hammer, args=(stores[1], [3, 2, 1, 0]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check = PlanStore(tmp_path, device="cpu")
    assert len(check) == 4
    for _, _, key, plan in plans:
        loaded = check.load(key)
        assert loaded is not None
        assert torch.equal(plan.h, loaded.h)
    assert check.stats.quarantined == 0
    # exactly one commit per key across both writers
    assert stores[0].stats.writes + stores[1].stats.writes == 4
