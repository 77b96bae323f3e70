"""The port's own spans on the CPU: ``core.spans`` and the stages after the
reference's ten.

A permutation's ``null_chunk`` holds its ``draw``; a grid's ``eval`` holds
one ``grid_point`` a point, each with the plan build's ``hat_matrix`` and
``fold_factors``; a registration with tracing on is a trace of its own whose
top level is ``fingerprint``; a served batch's members carry the gather
window inside their ``batch_wait``. None of it moves what was there: the
top-level ``timings()`` keys and the number of ``Tracer.sync`` calls of
every workload kind are pinned at the values before these spans, and with
no active trace the analysis functions record nothing and return the same
bits. ``t0_s`` puts a span on the process's ``perf_counter`` clock.
"""

import ast
import asyncio
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import fastcv, folds, multidim, permutation, spans
from repro_torch.serve import (AsyncEngineServer, CVEngine, DatasetSpec, EngineConfig,
                               EngineServer, Workload, run_workloads, stream_workload)
from repro_torch.serve import trace as trace_mod
from repro_torch.serve.trace import PORT_STAGES, STAGES, Trace, Tracer

N, P, K, LAM = 48, 96, 4, 1.0
Q = 3   # grid points


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, P))
    yc = np.arange(N) % 3
    y = np.where(yc % 2 == 0, -1.0, 1.0)
    x[y > 0, :4] += 1.0
    return x, y, yc, folds.kfold(N, K, seed=1, device="cpu")


def _engine() -> CVEngine:
    return CVEngine(EngineConfig(device="cpu"))


def _workloads(engine, problem) -> dict:
    x, y, yc, f = problem
    handle = engine.register(torch.tensor(x), f, LAM)
    spec = DatasetSpec(None, (np.asarray(f.te_idx), np.asarray(f.tr_idx)), LAM)
    models = np.stack([1.0 - np.eye(3), np.abs(np.arange(3)[:, None] - np.arange(3))])
    return {
        "cv": Workload(kind="cv", dataset=handle, y=y),
        "cv_multiclass": Workload(kind="cv", dataset=handle, y=yc, estimator="multiclass",
                                  num_classes=3),
        "permutation": Workload(kind="permutation", dataset=handle, y=y, n_perm=16, seed=1),
        "permutation_multiclass": Workload(kind="permutation", dataset=handle, y=yc,
                                           estimator="multiclass", num_classes=3,
                                           n_perm=16, seed=1),
        "rsa": Workload(kind="rsa", dataset=handle, y=yc, num_classes=3, model_rdms=models,
                        n_perm=8, seed=2),
        "tune": Workload(kind="tune", x=x, y=y),
        "grid": Workload(kind="grid", dataset=spec,
                         xs=np.stack([x[:, 8 * q:8 * q + 8] for q in range(Q)]), y=y),
        "update": Workload(kind="update", dataset=handle,
                           x=np.random.default_rng(3).normal(size=(4, P))),
    }


def _find(spans_, name):
    """Every span dict named ``name`` in a span tree, depth first."""
    out = []
    for sp in spans_:
        if sp["name"] == name:
            out.append(sp)
        out.extend(_find(sp.get("children", []), name))
    return out


def _traced(problem, kind, warm=False):
    """(response, trace dict) of one traced workload of ``kind`` on a fresh
    engine; ``warm`` serves it once untraced first."""
    engine = _engine()
    ws = _workloads(engine, problem)
    if warm:
        run_workloads(engine, [ws[kind]])
        ws = _workloads(engine, problem)
    engine.enable_tracing()
    resp = run_workloads(engine, [ws[kind]])[0]
    (tr,) = engine.tracer.last(1)
    return resp, tr


# ---------------------------------------------------------------------------
# The vocabulary and the hook
# ---------------------------------------------------------------------------


def test_port_stages_follow_the_reference_and_are_declared():
    assert STAGES[-len(PORT_STAGES):] == PORT_STAGES
    assert len(set(STAGES)) == len(STAGES)
    engine = _engine()
    text = engine.metrics.render_prometheus()
    for stage in PORT_STAGES:
        assert f'stage_latency_seconds_bucket{{stage="{stage}"' in text


def test_the_hook_is_the_shared_null_without_a_trace():
    assert spans.CURRENT.get() is None
    assert spans.span("draw") is spans.NULL
    assert Tracer().span("draw") is spans.NULL
    assert Tracer(enabled=True).span("eval") is spans.NULL     # enabled, nothing active
    tracer = Tracer(enabled=True)
    tr = tracer.trace()
    with tracer.activate(tr):
        assert spans.CURRENT.get() is tr
        with spans.span("grid_point"), tracer.span("hat_matrix"):
            pass
    assert spans.CURRENT.get() is None
    assert [s.name for s in tr.spans] == ["grid_point"]
    assert [c.name for c in tr.spans[0].children] == ["hat_matrix"]


def test_core_imports_nothing_from_serve():
    core = Path(spans.__file__).parent
    for path in sorted(core.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not any(n.startswith("repro_torch.serve") for n in names), path.name
    src = ast.parse(Path(spans.__file__).read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(src) if isinstance(n, ast.Import)
            for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(src)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert tops <= {"__future__", "contextlib", "contextvars"}


# ---------------------------------------------------------------------------
# Where the new spans land
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["permutation", "permutation_multiclass"])
def test_permutation_null_chunk_holds_a_draw(problem, kind):
    _, tr = _traced(problem, kind, warm=True)
    chunks = [sp for sp in tr["spans"] if sp["name"] == "null_chunk"]
    holding = [sp for sp in chunks if _find(sp.get("children", []), "draw")]
    assert len(holding) == 1 and len(_find(tr["spans"], "draw")) == 1
    (draw,) = _find(holding[0]["children"], "draw")
    assert draw["duration_s"] <= holding[0]["duration_s"]
    assert "draw" not in tr["timings"]


def test_grid_eval_holds_a_grid_point_per_point(problem):
    _, tr = _traced(problem, "grid")
    (ev,) = [sp for sp in tr["spans"] if sp["name"] == "eval"]
    points = ev["children"]
    assert [p["name"] for p in points] == ["grid_point"] * Q
    for p in points:
        assert [c["name"] for c in p["children"]] == ["hat_matrix", "fold_factors"]
        assert sum(c["duration_s"] for c in p["children"]) <= p["duration_s"]
    assert sum(p["duration_s"] for p in points) <= ev["duration_s"]


def test_plan_build_holds_hat_matrix_and_fold_factors(problem):
    _, tr = _traced(problem, "cv")
    (build,) = [sp for sp in tr["spans"] if sp["name"] == "plan_build"]
    assert [c["name"] for c in build["children"]] == ["hat_matrix", "fold_factors"]


def test_register_with_tracing_is_a_trace_of_its_own(problem):
    x, _, _, f = problem
    engine = _engine()
    hist = engine.metrics.get("stage_latency_seconds")
    engine.register(torch.tensor(x), f, LAM)                  # tracing off: nothing
    assert engine.tracer.last() == [] and hist.snapshot(stage="fingerprint")["count"] == 0
    engine.enable_tracing()
    handle = engine.register(torch.tensor(x[:, ::-1].copy()), f, LAM)
    (tr,) = engine.tracer.last()
    assert tr["kind"] == "register"
    assert [sp["name"] for sp in tr["spans"]] == ["fingerprint"]
    assert list(tr["timings"]) == ["fingerprint"]
    snap = hist.snapshot(stage="fingerprint")
    assert snap["count"] == 1 and snap["sum"] == pytest.approx(tr["timings"]["fingerprint"])
    assert engine.tracer.summary()["fingerprint"]["count"] == 1
    # a workload on the handle mints no key, so it fingerprints nothing
    run_workloads(engine, [Workload(kind="cv", dataset=handle, y=problem[1])])
    assert not _find(engine.tracer.last(1)[0]["spans"], "fingerprint")
    assert hist.snapshot(stage="fingerprint")["count"] == 1


def test_an_inline_dataset_fingerprints_under_cache_lookup(problem):
    x, y, _, f = problem
    engine = _engine()
    engine.enable_tracing()
    run_workloads(engine, [Workload(kind="cv", dataset=DatasetSpec(x, f, LAM), y=y)])
    (tr,) = engine.tracer.last(1)
    lookups = [sp for sp in tr["spans"] if sp["name"] == "cache_lookup"]
    assert sum(len(_find(sp.get("children", []), "fingerprint")) for sp in lookups) == 1
    assert "fingerprint" not in tr["timings"]


def _batch_waits(engine) -> list:
    return [(sp, tr) for tr in engine.tracer.last(100) for sp in tr["spans"]
            if sp["name"] == "batch_wait"]


def _assert_gather_inside(engine, n):
    waits = _batch_waits(engine)
    assert len(waits) == n
    for wait, tr in waits:
        (gather,) = wait["children"]
        assert gather["name"] == "gather"
        assert wait["start_s"] <= gather["start_s"] + 1e-12
        assert (gather["start_s"] + gather["duration_s"]
                <= wait["start_s"] + wait["duration_s"] + 1e-12)
        assert "gather" not in tr["timings"] and "batch_wait" in tr["timings"]


def test_async_batch_members_carry_gather_inside_batch_wait(problem):
    x, y, _, f = problem
    engine = _engine()
    handle = engine.register(torch.tensor(x), f, LAM)
    run_workloads(engine, [Workload(kind="cv", dataset=handle, y=y)])
    engine.enable_tracing()

    async def drive():
        async with AsyncEngineServer(engine, gather_window_ms=20.0) as server:
            await asyncio.gather(*(server.submit(Workload(kind="cv", dataset=handle, y=y))
                                   for _ in range(4)))
            return server.batches_served

    assert asyncio.run(drive()) >= 1
    _assert_gather_inside(engine, 4)


def test_threaded_batch_members_carry_gather_inside_batch_wait(problem):
    x, y, _, f = problem
    engine = _engine()
    handle = engine.register(torch.tensor(x), f, LAM)
    run_workloads(engine, [Workload(kind="cv", dataset=handle, y=y)])
    engine.enable_tracing()
    with EngineServer(engine, max_wait_ms=20.0) as server:
        futs = [server.submit(Workload(kind="cv", dataset=handle, y=y)) for _ in range(4)]
        for fut in futs:
            fut.result(timeout=60)
    _assert_gather_inside(engine, 4)


def test_gather_is_clipped_to_the_members_wait():
    tr = Trace()
    tr.mark_enqueue()
    t_enq = tr._t_enqueue
    now = t_enq + 0.5
    tr.note_dequeue(now, gathered_from=t_enq - 1.0)        # window opened before it came
    (wait,) = tr.spans
    (gather,) = wait.children
    assert gather.start == pytest.approx(wait.start) and gather.duration == wait.duration
    tr = Trace()
    tr.mark_enqueue()
    t_enq = tr._t_enqueue
    tr.note_dequeue(t_enq + 0.5, gathered_from=t_enq + 0.2)
    (wait,) = tr.spans
    assert wait.duration == pytest.approx(0.5)
    assert wait.children[0].duration == pytest.approx(0.3)
    tr = Trace()
    tr.mark_enqueue()
    tr.note_dequeue()                                       # no window: no child
    assert tr.spans[0].children == []


# ---------------------------------------------------------------------------
# What stays as it was
# ---------------------------------------------------------------------------

#: top-level timings() keys and Tracer.sync calls of one traced workload,
#: cold (the plan built in it) and warm, as they were before the port's stages
PINNED = {
    ("cold", "cv"): (3, ("validate", "plan_build", "cache_lookup", "eval", "encode")),
    ("cold", "cv_multiclass"): (3, ("validate", "plan_build", "cache_lookup", "eval",
                                    "encode")),
    ("cold", "permutation"): (7, ("validate", "plan_build", "cache_lookup", "eval",
                                  "null_chunk", "encode")),
    ("cold", "permutation_multiclass"): (7, ("validate", "plan_build", "cache_lookup", "eval",
                                             "null_chunk", "encode")),
    ("cold", "rsa"): (8, ("validate", "plan_build", "cache_lookup", "eval", "null_chunk",
                          "encode")),
    ("cold", "tune"): (1, ("validate", "eval", "encode")),
    ("cold", "grid"): (1, ("validate", "eval", "encode")),
    ("cold", "update"): (1, ("validate", "plan_update", "encode")),
    ("warm", "cv"): (2, ("validate", "cache_lookup", "eval", "encode")),
    ("warm", "cv_multiclass"): (2, ("validate", "cache_lookup", "eval", "encode")),
    ("warm", "permutation"): (6, ("validate", "cache_lookup", "eval", "null_chunk", "encode")),
    ("warm", "permutation_multiclass"): (6, ("validate", "cache_lookup", "eval", "null_chunk",
                                             "encode")),
    ("warm", "rsa"): (6, ("validate", "cache_lookup", "eval", "null_chunk", "encode")),
    ("warm", "tune"): (1, ("validate", "eval", "encode")),
    ("warm", "grid"): (1, ("validate", "eval", "encode")),
    ("warm", "update"): (0, ("validate", "plan_update", "encode")),
}


def _count_syncs(monkeypatch) -> list:
    calls = []
    original = trace_mod.Tracer.sync

    def counting(self, value):
        calls.append(1)
        return original(self, value)

    monkeypatch.setattr(trace_mod.Tracer, "sync", counting)
    return calls


@pytest.mark.parametrize("phase,kind", sorted(PINNED))
def test_timings_keys_and_sync_calls_are_pinned(problem, monkeypatch, phase, kind):
    calls = _count_syncs(monkeypatch)
    engine = _engine()
    ws = _workloads(engine, problem)
    if phase == "warm":
        run_workloads(engine, [ws[kind]])
        ws = _workloads(engine, problem)
    engine.enable_tracing()
    calls.clear()
    resp = run_workloads(engine, [ws[kind]])[0]
    syncs, keys = PINNED[phase, kind]
    assert tuple(resp.timings) == keys
    assert len(calls) == syncs


@pytest.mark.parametrize("kind,syncs,keys", [
    ("permutation", 6, ("validate", "plan_build", "cache_lookup", "eval", "null_chunk",
                        "encode")),
    ("rsa", 5, ("validate", "plan_build", "cache_lookup", "eval", "null_chunk", "encode")),
])
def test_streamed_timings_keys_and_sync_calls_are_pinned(problem, monkeypatch, kind, syncs,
                                                         keys):
    calls = _count_syncs(monkeypatch)
    engine = _engine()
    w = _workloads(engine, problem)[kind]
    engine.enable_tracing()
    calls.clear()
    events = list(stream_workload(engine, w, chunk=4))
    assert tuple(events[-1].payload.timings) == keys
    assert len(calls) == syncs


def test_no_active_trace_records_nothing_and_returns_the_same_bits(problem):
    x, y, _, f = problem
    xs = torch.tensor(np.stack([x[:, 8 * q:8 * q + 8] for q in range(Q)]))
    yt = torch.tensor(y)
    idle = Trace()                                           # made, never activated
    plain_grid = multidim.cv_grid(xs, yt, f, LAM)
    plain_draw = permutation.permutation_indices(7, N, 12, device="cpu")
    plain_key = fastcv.plan_key(torch.tensor(x), f, LAM)
    assert idle.spans == [] and spans.CURRENT.get() is None
    tracer = Tracer(enabled=True)
    tr = tracer.trace()
    with tracer.activate(tr):
        traced_grid = multidim.cv_grid(xs, yt, f, LAM)
        traced_draw = permutation.permutation_indices(7, N, 12, device="cpu")
        traced_key = fastcv.plan_key(torch.tensor(x), f, LAM)
    assert torch.equal(plain_grid, traced_grid) and torch.equal(plain_draw, traced_draw)
    assert plain_key == traced_key
    assert [s.name for s in tr.spans] == ["grid_point"] * Q + ["draw", "fingerprint"]


def test_shared_times_once_for_every_member(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    tracer = Tracer()
    a, b = Trace(), Trace()
    with tracer.shared("eval", [a, None, b], "cpu"):
        pass
    assert a.spans == [] and b.spans == []                  # off: nothing timed
    tracer.enable()
    with tracer.shared("eval", [a, None, b], "cpu"):
        time.sleep(0.002)
    assert [s.name for s in a.spans] == [s.name for s in b.spans] == ["eval"]
    assert a.spans[0].duration == b.spans[0].duration >= 0.002
    with pytest.raises(RuntimeError), tracer.shared("plan_update", [a], "cpu"):
        raise RuntimeError("the shared work failed")
    assert [s.name for s in a.spans] == ["eval"]            # a failure adds nothing
    assert calls == []                                      # the CPU: no wait


# ---------------------------------------------------------------------------
# One clock
# ---------------------------------------------------------------------------


def test_t0_plus_start_is_on_the_perf_counter_clock():
    tracer = Tracer(enabled=True)
    tr = tracer.trace()
    with tracer.activate(tr):
        time.sleep(0.001)
        before = time.perf_counter()
        with tracer.span("eval"):
            time.sleep(0.001)
        after = time.perf_counter()
    tracer.finish(tr)
    d = tr.to_dict()
    (sp,) = d["spans"]
    start = d["t0_s"] + sp["start_s"]
    assert before <= start <= start + sp["duration_s"] <= after
