"""repro_torch.serve.api and .client on the CPU, against the reference's.

``serve`` is ``run_workloads``; ``EngineServer`` hands concurrent
submitters futures over shared micro-batches, serves what was queued
before ``stop`` and refuses what comes after; ``Client`` gives the same
results over its three transports (sync, thread, async), each held against
the reference's ``Client`` on the same f64 inputs (≤ 1e-9 relative, the
tolerance of tests/test_torch_workload.py; permutation nulls are drawn
differently by the two packages, so a permutation test is held by its
observed value and its null by the port's own monolithic run), streams the
same events on every transport, and records the traffic the reference's
``Client`` records. ``Client()`` and ``EdgeThread()`` build ``CVEngine()``,
which takes the card and raises without one; the engine threads of
``EngineServer`` and ``AsyncEngineServer`` make the engine's device
current before they serve.
"""

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folds as ref_folds
from repro.serve import Client as RefClient
from repro.serve import CVEngine as RefEngine
from repro.serve import TrafficLog as RefTrafficLog
from repro.serve import Workload as RefWorkload
from repro_torch import rsa
from repro_torch.core import folds as foldlib
from repro_torch.serve import (AsyncEngineServer, Client, CVEngine, DatasetHandle, EdgeThread,
                               EngineConfig, EngineServer, TrafficLog, Workload, run_workloads,
                               serve)
from repro_torch.serve import api as api_mod
from repro_torch.serve.http import assert_responses_equal

N, P, K, LAM = 48, 96, 4, 1.0
TOL = 1e-9
TRANSPORTS = ("sync", "thread", "async")


def _engine() -> CVEngine:
    return CVEngine(EngineConfig(device="cpu"))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    yc = np.arange(N) % 3
    x = rng.normal(size=(N, P))
    x[:, :6] += 1.2 * yc[:, None]
    y = np.where(yc % 2 == 0, -1.0, 1.0)
    f = foldlib.kfold(N, K, seed=1, device="cpu")
    return x, y, yc, f


def _workloads(problem, dataset, W=Workload):
    x, y, yc, _ = problem
    ring = rsa.ring_rdm(3, device="cpu").numpy()
    return [
        W(kind="cv", dataset=dataset, y=y),
        W(kind="cv", dataset=dataset, y=np.stack([y, -y, np.roll(y, 3)], axis=1)),
        W(kind="cv", dataset=dataset, y=y, estimator="ridge"),
        W(kind="cv", dataset=dataset, y=yc, estimator="multiclass", num_classes=3),
        W(kind="permutation", dataset=dataset, y=y, n_perm=12, seed=4),
        W(kind="rsa", dataset=dataset, y=yc, num_classes=3,
          model_rdms=np.stack([ring, ring * 0.5 + 0.1]), n_perm=8, seed=2),
        W(kind="tune", x=x, y=y),
    ]


@pytest.fixture(scope="module")
def reference(problem):
    """The reference Client's responses and recorded traffic for the batch."""
    x, _, _, _ = problem
    log = RefTrafficLog()
    client = RefClient(RefEngine(), record=log)
    handle = client.register(jnp.asarray(x), ref_folds.kfold(N, K, seed=1), LAM)
    return client.gather(_workloads(problem, handle, RefWorkload)), log, handle, client


def _held_to_reference(got, want):
    for a, b in zip(got, want, strict=True):
        assert type(a).__name__ == type(b).__name__
        if hasattr(b, "values"):
            _close(a.values, b.values)
        elif hasattr(b, "observed"):
            _close(a.observed, b.observed)
        elif hasattr(b, "rdm"):
            _close(a.rdm, b.rdm)
            _close(a.model_scores, b.model_scores)
        else:
            _close(a.result.scores, b.result.scores)


# ---------------------------------------------------------------------------
# serve and EngineServer
# ---------------------------------------------------------------------------


def test_serve_is_run_workloads(problem):
    engine = _engine()
    handle = engine.register(problem[0], problem[3], LAM)
    ws = _workloads(problem, handle)
    for a, b in zip(serve(engine, ws), run_workloads(engine, ws)):
        assert_responses_equal(a, b)


def test_engine_server_coalesces_concurrent_submitters(problem):
    engine = _engine()
    handle = engine.register(problem[0], problem[3], LAM)
    ws = _workloads(problem, handle)
    other = _engine()
    want = run_workloads(other, _workloads(problem, other.register(problem[0], problem[3], LAM)))
    results = [None] * len(ws)
    with EngineServer(engine, max_wait_ms=20.0) as server:
        def submit(i):
            results[i] = server.submit(ws[i]).result(timeout=120)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(ws))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert server.requests_served == len(ws)
        assert server.batches_served < len(ws)                 # coalesced
    for a, b in zip(results, want):
        assert_responses_equal(a, b)
    assert engine.plans_built == 1


def test_engine_server_serves_what_was_queued_and_refuses_after_stop(problem):
    engine = _engine()
    handle = engine.register(problem[0], problem[3], LAM)
    server = EngineServer(engine, max_wait_ms=50.0).start()
    with pytest.raises(RuntimeError, match="already started"):
        server.start()
    futs = [server.submit(w) for w in _workloads(problem, handle)[:4]]
    server.stop()
    assert all(f.done() and f.exception() is None for f in futs)
    with pytest.raises(RuntimeError, match="not running"):
        server.submit(Workload(kind="cv", dataset=handle, y=problem[1]))


def test_engine_server_fails_only_the_bad_entry(problem):
    engine = _engine()
    handle = engine.register(problem[0], problem[3], LAM)
    bad = DatasetHandle(key=("bogus", "te", "tr", 1.0, "dual", True), n=N, p=P, lam=LAM)
    with EngineServer(engine, max_wait_ms=20.0) as server:
        good = server.submit(Workload(kind="cv", dataset=handle, y=problem[1]))
        wrong = server.submit(Workload(kind="cv", dataset=bad, y=problem[1]))
        assert isinstance(wrong.exception(timeout=60), KeyError)
        assert good.result(timeout=60).values.shape == (K, N // K)


# ---------------------------------------------------------------------------
# Client: three transports, one result, the reference's
# ---------------------------------------------------------------------------


def _gather(client, ws):
    if client.transport == "async":
        async def drive():
            async with client:
                return await client.gather(ws)

        return asyncio.run(drive())
    with client:
        return client.gather(ws)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_client_transports_match_the_reference_client(problem, reference, transport):
    ref_responses, _, ref_handle, _ = reference
    engine = _engine()
    client = Client(engine, transport=transport)
    handle = client.register(problem[0], problem[3], LAM)
    assert handle.key == ref_handle.key
    got = _gather(client, _workloads(problem, handle))
    _held_to_reference(got, ref_responses)
    # the nulls: the port's own monolithic draws, bit for bit
    (mono,) = run_workloads(engine, [_workloads(problem, handle)[4]])
    assert torch.equal(got[4].null, mono.null)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_client_streams_the_same_events_on_every_transport(problem, transport):
    engine = _engine()
    client = Client(engine, transport=transport, stream_chunk=8)
    handle = client.register(problem[0], problem[3], LAM)
    w = Workload(kind="permutation", dataset=handle, y=problem[1], n_perm=20, seed=5)

    if transport == "async":
        async def drive():
            async with client:
                return [ev async for ev in client.stream(w)]

        events = asyncio.run(drive())
    else:
        with client:
            events = list(client.stream(w))
    assert [(e.kind, e.done) for e in events] == [("plan", 0), ("observed", 0), ("null", 8),
                                                  ("null", 16), ("null", 20), ("done", 20)]
    (mono,) = run_workloads(engine, [w])
    assert torch.equal(torch.cat([e.payload for e in events if e.kind == "null"]), mono.null)
    assert_responses_equal(events[-1].payload, mono)


def test_client_records_what_the_reference_client_records(problem, reference):
    _, ref_log, ref_handle, ref_client = reference
    log = TrafficLog()
    client = Client(_engine(), record=log)
    handle = client.register(problem[0], problem[3], LAM)
    client.gather(_workloads(problem, handle))
    assert log.entries() == ref_log.entries()
    # a stream also records its chunk's bucket
    client.stream(Workload(kind="permutation", dataset=handle, y=problem[1], n_perm=200))
    ref_client.stream(RefWorkload(kind="permutation", dataset=ref_handle, y=problem[1],
                                  n_perm=200))
    assert len(log) > len(_workloads(problem, handle))
    assert log.entries() == ref_log.entries()


def test_client_refuses_misuse(problem):
    engine = _engine()
    with pytest.raises(ValueError, match="transport"):
        Client(engine, transport="carrier-pigeon")
    with pytest.raises(RuntimeError, match="async with"):
        with Client(engine, transport="async"):
            pass
    with pytest.raises(RuntimeError, match="entered first"):
        Client(engine, transport="async").submit(
            Workload(kind="cv", dataset=engine.register(problem[0], problem[3], LAM),
                     y=problem[1]))

    async def wrong():
        async with Client(engine):
            pass

    with pytest.raises(RuntimeError, match="transport='async'"):
        asyncio.run(wrong())


def test_client_fronts_the_registry(problem):
    client = Client(_engine())
    handle = client.register(problem[0], problem[3], LAM)
    (info,) = client.datasets()
    assert info["handle"] == handle
    h1 = client.append(handle, np.random.default_rng(2).normal(size=(K, P)))
    h2 = client.retire(h1, [0, 1, 2, 3])
    assert (h1.version, h1.n, h2.version, h2.n) == (1, N + K, 2, N)
    info = client.warmup(handle, tasks=("binary",), buckets=(1, 2))
    assert info["buckets"] == (1, 2)
    assert client.stats()["plans_updated"] == 2
    assert client.metrics() is client.engine.metrics
    assert client.trace_summary() == {}                       # tracing is off
    assert client.server is None


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def test_default_client_and_edge_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Client()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeThread()


def test_engine_threads_bind_the_engines_device(problem, monkeypatch):
    """Each engine thread makes the engine's device current before it serves
    (a no-op on the CPU; on a card, torch.cuda.set_device)."""
    from repro_torch.serve import aio as aio_mod

    original = api_mod.bind_engine_device
    bound = []

    def record(engine):
        bound.append((threading.current_thread().name, engine.device))
        original(engine)

    monkeypatch.setattr(api_mod, "bind_engine_device", record)
    monkeypatch.setattr(aio_mod, "bind_engine_device", record)
    engine = _engine()
    handle = engine.register(problem[0], problem[3], LAM)
    with EngineServer(engine) as server:
        server.submit(Workload(kind="cv", dataset=handle, y=problem[1])).result(timeout=60)

    async def drive():
        async with AsyncEngineServer(engine) as server:
            await server.submit(Workload(kind="cv", dataset=handle, y=problem[1]))

    asyncio.run(drive())
    assert [name.split("_")[0] for name, _ in bound] == ["cv-engine-server", "cv-engine-aio"]
    assert all(dev == engine.device for _, dev in bound)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    original(_engine())                                       # the CPU: nothing to bind
    original(type("CardEngine", (), {"device": torch.device("cuda", 0)})())
    assert calls == [torch.device("cuda", 0)]
