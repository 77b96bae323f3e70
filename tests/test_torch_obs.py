"""repro_torch.serve's observability tables, registry and tracer on the CPU.

The port's ``METRICS`` and ``BUCKET_FAMILIES`` equal the reference's entry
for entry, and its ``STAGES`` are the reference's followed by its own
(reprolint checks every call site in ``src/`` against the port's tables);
the same operations on both packages' registries render the same
Prometheus text; spans, ``timings`` and the ring behave as the reference's;
``Tracer.sync`` waits only with an active trace; an engine on the CPU
attaches ``timings`` only when tracing is on.
"""

import re

import numpy as np
import pytest
import torch

from repro.serve import obs as ref_obs
from repro.serve import trace as ref_trace
from repro_torch.core import fastcv, folds
from repro_torch.serve import (STAGES, CVEngine, DatasetSpec, EngineConfig, MetricsRegistry,
                               Workload, run_workloads, stream_workload)
from repro_torch.serve import obs, trace
from repro_torch.serve.trace import Trace, Tracer, attach_trace, trace_of

N, P, K, LAM = 48, 96, 4, 1.0


def test_vocabularies_equal_the_reference():
    # the reference's stages are the prefix of the port's; the rest are the
    # port's own, declared as such
    n = len(ref_trace.STAGES)
    assert trace.STAGES[:n] == ref_trace.STAGES
    assert trace.STAGES[n:] == trace.PORT_STAGES
    assert obs.METRICS == ref_obs.METRICS
    assert obs.BUCKET_FAMILIES == ref_obs.BUCKET_FAMILIES
    assert obs.LATENCY_BUCKETS_S == ref_obs.LATENCY_BUCKETS_S
    assert obs.SIZE_BUCKETS == ref_obs.SIZE_BUCKETS


def _drive(reg):
    """One script of registry operations: counters, gauges, histograms and
    the cardinality cap, as the reference's tests drive them."""
    c = reg.counter("reqs", "requests", labels=("kind",))
    c.inc(kind="cv")
    c.inc(2, kind="cv")
    reg.inc("reqs", kind="rsa")
    state = {"v": 7}
    reg.gauge("live", "callback-backed", fn=lambda: state["v"])
    g = reg.gauge("set", "set directly")
    g.set(2.5)
    h = reg.histogram("lat", "latency", buckets=(0.1, 1.0, 10.0), labels=("stage",))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v, stage="eval")
    h.declare(stage="encode")
    capped = reg.counter("labelled", "capped", labels=("who",))
    for i in range(10):
        capped.inc(who=f"client-{i}")
    state["v"] = 11
    return c, h, capped


@pytest.mark.parametrize("cap", [4, 64])
def test_registry_renders_what_the_reference_renders(cap):
    mine, ref = MetricsRegistry(max_series_per_metric=cap), ref_obs.MetricsRegistry(
        max_series_per_metric=cap)
    c, h, capped = _drive(mine)
    _drive(ref)
    assert mine.render_prometheus() == ref.render_prometheus()
    assert mine.as_dict() == ref.as_dict()
    assert mine.dropped_series == ref.dropped_series == (6 if cap == 4 else 0)
    assert c.value(kind="cv") == 3 and c.value(kind="tune") == 0
    assert h.snapshot(stage="eval") == {"count": 5, "sum": pytest.approx(56.05),
                                        "buckets": [1, 2, 1]}
    text = mine.render_prometheus()
    assert 'lat_bucket{stage="eval",le="+Inf"} 5' in text and "live 11" in text


def test_registry_refuses_what_the_reference_refuses():
    reg = MetricsRegistry()
    c = reg.counter("x", "first")
    assert reg.counter("x", "again") is c
    g = reg.gauge("cb", "callback", fn=lambda: 1)
    for bad in (lambda: c.inc(-1), lambda: reg.gauge("x"), lambda: reg.histogram("x"),
                lambda: g.set(3), lambda: reg.histogram("h", buckets=(2.0, 1.0))):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(KeyError):
        reg.inc("no_such_metric")
    with pytest.raises(TypeError):
        reg.inc("cb")
    with pytest.raises(ValueError):
        reg.counter("lab", labels=("a",)).inc(b=1)


def test_span_tree_timings_and_ring():
    tr = Trace(kind="cv")
    with tr.span("eval"):
        with tr.span("null_chunk"):
            pass
    with tr.span("encode"):
        pass
    tr.add("eval", 0.25)
    assert [s.name for s in tr.spans] == ["eval", "encode", "eval"]
    assert [c.name for c in tr.spans[0].children] == ["null_chunk"]
    t = tr.timings()
    assert list(t) == ["eval", "encode"]              # STAGES order, top level only
    assert t["eval"] >= 0.25
    assert tr.to_dict()["spans"][0]["children"][0]["name"] == "null_chunk"
    tracer = Tracer(enabled=True, ring=4, registry=MetricsRegistry())
    tracer.registry.histogram("stage_latency_seconds", labels=("stage",))
    for _ in range(10):
        tracer.finish(tracer.trace())
    tracer.finish(tr)
    assert tracer.ring_size == 4 and len(tracer.last(100)) == 4
    assert tracer.summary()["eval"]["count"] == 1
    assert tracer.registry.get("stage_latency_seconds").snapshot(stage="eval")["count"] == 1


def test_batch_wait_and_attach_guard():
    tracer = Tracer(enabled=True)
    tr = tracer.trace(kind="tune")
    tr.mark_enqueue()
    tr.note_dequeue()
    assert "batch_wait" in tr.timings()
    w = Workload(kind="tune", x=np.ones((8, 4)), y=np.ones(8))
    attach_trace(w, tr)
    assert trace_of(w) is tr
    tracer.finish(tr)
    assert trace_of(w) is None                         # finished traces are never reused
    assert trace.NULL_TRACER.trace() is None


def test_disabled_tracer_is_a_noop_and_sync_waits_only_when_active(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    tracer = Tracer()
    assert tracer.trace() is None and tracer.current() is None
    with tracer.activate(None), tracer.span("eval"):
        pass
    assert tracer.last() == [] and tracer.summary() == {}
    x = torch.ones(3)
    assert tracer.sync(x) is x                        # no active trace: nothing waits
    tracer.enable()
    with tracer.activate(tracer.trace()):
        plan = fastcv.CVPlan(x, x, x, x, None)
        pair = (plan, (x, x))
        assert tracer.sync(pair) is pair
    assert calls == []                                # CPU tensors need no wait


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, P))
    yc = np.arange(N) % 3
    y = np.where(yc % 2 == 0, -1.0, 1.0)
    x[y > 0, :4] += 1.0
    return x, y, yc, folds.kfold(N, K, seed=1, device="cpu")


def _kinds(engine, problem):
    x, y, yc, f = problem
    handle = engine.register(torch.tensor(x), f, LAM)
    models = np.stack([1.0 - np.eye(3), np.abs(np.arange(3)[:, None] - np.arange(3))])
    return [
        Workload(kind="cv", dataset=handle, y=y),
        Workload(kind="permutation", dataset=handle, y=y, n_perm=16, seed=1),
        Workload(kind="rsa", dataset=handle, y=yc, num_classes=3, model_rdms=models,
                 n_perm=8, seed=2),
        Workload(kind="tune", x=x, y=y),
        Workload(kind="grid", dataset=DatasetSpec(None, (np.asarray(f.te_idx),
                                                         np.asarray(f.tr_idx)), LAM),
                 xs=np.stack([x[:, :8], x[:, 8:16]]), y=y),
    ]


def test_engine_timings_only_when_tracing(problem):
    engine = CVEngine(EngineConfig(device="cpu"))
    ws = _kinds(engine, problem)
    first = run_workloads(engine, ws)
    compiles = engine.compile_count()
    assert all(r.timings is None for r in first) and engine.tracer.last() == []
    engine.enable_tracing(ring=16)
    traced = run_workloads(engine, ws)
    assert engine.compile_count() == compiles          # tracing serves no new shape
    for resp in traced:
        assert resp.timings and set(resp.timings) <= set(STAGES)
        assert all(v >= 0.0 for v in resp.timings.values())
    assert {"validate", "eval", "null_chunk", "encode"} <= set().union(
        *(r.timings for r in traced))
    events = list(stream_workload(engine, ws[1], chunk=4))
    assert events[-1].kind == "done" and events[-1].payload.timings
    assert len(engine.tracer.last(100)) == len(ws) + 1
    text = engine.metrics.render_prometheus()
    assert 'requests_total{kind="cv",estimator="binary"} 2' in text
    assert f"compile_events {engine.compile_count()}" in text
    for stage in STAGES:
        assert f'stage_latency_seconds_bucket{{stage="{stage}"' in text


_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ?.*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9][0-9eE+.\-]*)$"
)


def test_engine_exposition_is_prometheus_text(problem):
    engine = CVEngine(EngineConfig(device="cpu"))
    run_workloads(engine, _kinds(engine, problem)[:1])
    text = engine.metrics.render_prometheus()
    assert text.endswith("\n")
    for line in text.rstrip("\n").split("\n"):
        assert _PROM_LINE.match(line), line
    assert set(engine.metrics.as_dict()) == set(obs.METRICS)


# ---------------------------------------------------------------------------
# The reference's obs contracts (tests/test_obs.py), held on the port
# ---------------------------------------------------------------------------


def test_cardinality_cap_folds_into_other():
    reg = MetricsRegistry(max_series_per_metric=4)
    c = reg.counter("labelled", "capped", labels=("who",))
    for i in range(10):
        c.inc(who=f"client-{i}")
    assert len(c._series) <= 5  # 4 real + 1 overflow
    assert reg.dropped_series == 6
    assert c.value(who="_other") == 6
    text = reg.render_prometheus()
    assert 'labelled{who="_other"} 6' in text
    assert "obs_dropped_series 6" in text


_GOLDEN_STATS_KEYS = {
    "hits", "misses", "evictions", "oversized", "pinned", "pinned_bytes", "bytes_in_use",
    "byte_budget", "plans_built", "plans_updated", "labels_evaluated", "compiles",
    "datasets_registered", "rdm_hits", "rdm_entries", "store_hits", "store_misses",
    "store_writes", "store_bytes", "per_dataset",
}


def test_stats_schema_golden(problem):
    from repro_torch.serve import Client

    x, y, _, f = problem
    engine = CVEngine(EngineConfig(device="cpu"))
    handle = engine.register(x, f, LAM)
    Client(engine).submit(Workload(kind="cv", dataset=handle, y=y, estimator="binary"))
    s = engine.stats()
    assert set(s) == _GOLDEN_STATS_KEYS
    per = s["per_dataset"]
    assert len(per) == 1
    (rec,) = per.values()
    assert set(rec) == {"n", "p", "version", "n_appended", "served",
                        "plan_bytes", "resident", "pinned", "last_used"}
    assert rec["version"] == 0 and rec["n_appended"] == 0
    assert rec["n"] == N and rec["p"] == P
    assert rec["served"] == 1
    assert rec["resident"] and rec["plan_bytes"] > 0
    assert rec["last_used"] > 0.0
