"""repro_torch.serve.aio on the CPU: the contracts of the reference's
tests/test_async_serve.py, one test each, held on the port.

Concurrent ragged clients against the async server agree with the sync
runner and with the direct library answers (≤ 1e-9 relative; on the CPU
the composite does not depend on the bucket, so they are in fact equal);
streamed permutation and RSA responses equal the monolithic ones chunk by
chunk (the port's draws: ``core.permutation.permutation_indices`` of the
seed); warm-up keeps ``compile_count`` flat under concurrent mixed
traffic; pinned plans survive cache pressure. The mixed batch is also held
against the reference's sync runner on the same f64 inputs (≤ 1e-9; a
permutation's null is drawn differently by the two packages, so only its
observed value is compared).
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folds as ref_folds
from repro.serve import CVEngine as RefEngine
from repro.serve import DatasetSpec as RefSpec
from repro.serve import Workload as RefWorkload
from repro.serve import serve as ref_serve
from repro_torch import rsa
from repro_torch.core import fastcv
from repro_torch.core import folds as foldlib
from repro_torch.serve import (AsyncEngineServer, CVEngine, DatasetSpec, EngineConfig,
                               ProgressEvent, Workload, serve)

N, P, K, LAM = 48, 96, 4, 1.0
TOL = 1e-9


def _engine(**kw) -> CVEngine:
    return CVEngine(EngineConfig(device="cpu", **kw))


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


def _spec(problem):
    x, _, _, f = problem
    return DatasetSpec(x, f, LAM)


def _mixed_requests(W, spec, problem, n_perm=12):
    x, y, yc, _ = problem
    return [
        W(kind="cv", dataset=spec, y=y, estimator="binary"),
        W(kind="cv", dataset=spec, y=-y, estimator="binary"),
        W(kind="cv", dataset=spec, y=np.stack([y, -y, np.roll(y, 3)], axis=1),
          estimator="binary"),
        W(kind="cv", dataset=spec, y=y, estimator="ridge"),
        W(kind="cv", dataset=spec, y=yc, estimator="multiclass", num_classes=3),
        W(kind="permutation", dataset=spec, y=y, n_perm=n_perm, seed=4),
        W(kind="tune", x=x, y=y),
    ]


# ---------------------------------------------------------------------------
# Concurrent submission: correctness per request, one plan, shared batches
# ---------------------------------------------------------------------------


def test_async_server_matches_sync(problem):
    requests = _mixed_requests(Workload, _spec(problem), problem)
    sync = serve(_engine(), requests)
    engine = _engine()

    async def main():
        async with AsyncEngineServer(engine, gather_window_ms=5.0) as server:
            return await asyncio.gather(*(server.submit(r) for r in requests))

    results = asyncio.run(main())
    for got, want in zip(results, sync):
        assert type(got) is type(want)
        if hasattr(want, "values"):
            _close(got.values, want.values)
        elif hasattr(want, "null"):
            _close(got.null, want.null)
    # every request shares the one dataset -> one plan build total
    assert engine.stats()["plans_built"] == 1
    # and the reference's sync runner on the same inputs
    x, _, _, f = problem
    ref_spec = RefSpec(jnp.asarray(x), ref_folds.kfold(N, K, seed=1), LAM)
    want = ref_serve(RefEngine(), _mixed_requests(RefWorkload, ref_spec, problem))
    for got, ref in zip(results, want):
        assert type(got).__name__ == type(ref).__name__
        if hasattr(ref, "values"):
            _close(got.values, np.asarray(ref.values))
        elif hasattr(ref, "observed"):
            _close(got.observed, np.asarray(ref.observed))
        else:
            _close(got.result.scores, np.asarray(ref.result.scores))


def test_async_ragged_concurrent_clients(problem):
    """8 clients with ragged mixed-task streams: per-request results must
    match the direct library answers, through shared coalesced batches."""
    x, y, yc, f = problem
    spec = DatasetSpec(x, f, LAM)
    engine = _engine()
    dv_direct, _ = fastcv.binary_cv(torch.tensor(x), torch.tensor(y), f, lam=LAM)

    async def client(server, cid):
        width = 1 + cid % 3
        cols = np.stack([np.roll(y, cid + j) for j in range(width)], axis=1)
        resp_b = await server.submit(
            Workload(kind="cv", dataset=spec, y=cols, estimator="binary"))
        resp_m = await server.submit(
            Workload(kind="cv", dataset=spec, y=yc, estimator="multiclass", num_classes=3))
        return cid, cols, resp_b, resp_m

    async def main():
        async with AsyncEngineServer(engine, gather_window_ms=5.0) as server:
            out = await asyncio.gather(*(client(server, cid) for cid in range(8)))
            return out, server.requests_served, server.batches_served

    out, served, batches = asyncio.run(main())
    assert served == 16
    assert batches < served  # concurrency actually coalesced
    e_ref = _engine()
    _, plan = e_ref.plan(x, f, LAM)
    pred_ref = e_ref.eval_multiclass(plan, yc, 3)
    for cid, cols, resp_b, resp_m in out:
        assert resp_b.values.shape[-1] == cols.shape[1]
        _close(resp_b.values, e_ref.eval_binary(plan, cols))
        assert torch.equal(resp_m.values, pred_ref)
    assert engine.stats()["plans_built"] == 1
    # client 0's first column is the unrolled y -> the direct library answer
    _close(out[0][2].values[..., 0], dv_direct)


def test_async_server_propagates_errors(problem):
    engine = _engine()
    # Estimator names are validated eagerly at construction, so smuggle an
    # invalid one past __post_init__ to exercise serve-time propagation.
    bad = Workload(kind="cv", dataset=_spec(problem), y=problem[1])
    object.__setattr__(bad, "estimator", "nonsense")

    async def main():
        async with AsyncEngineServer(engine) as server:
            with pytest.raises(ValueError):
                await server.submit(bad)

    asyncio.run(main())


def test_async_server_rejects_after_stop(problem):
    engine = _engine()

    async def main():
        server = AsyncEngineServer(engine)
        await server.start()
        await server.stop()
        with pytest.raises(RuntimeError):
            await server.submit(Workload(kind="cv", dataset=_spec(problem), y=problem[1]))

    asyncio.run(main())


# ---------------------------------------------------------------------------
# Warm-up: compile_count stays flat under concurrent mixed traffic
# ---------------------------------------------------------------------------


def test_warmup_then_zero_recompiles_under_traffic(problem):
    x, y, yc, f = problem
    spec = DatasetSpec(x, f, LAM)
    engine = _engine()
    info = engine.warmup(
        spec,
        tasks=("binary", "ridge", "multiclass", "permutation"),
        buckets=(1, 2, 4, 8, 16),
        num_classes=3,
    )
    assert info["buckets"] == (1, 2, 4, 8, 16)
    warm = engine.compile_count()
    assert warm == info["compiles"]

    async def client(server, cid):
        await server.submit(
            Workload(kind="cv", dataset=spec, y=np.roll(y, cid), estimator="binary"))
        await server.submit(
            Workload(kind="cv", dataset=spec, y=yc, estimator="multiclass", num_classes=3))
        await server.submit(
            Workload(kind="cv", dataset=spec, y=np.roll(y, cid + 1), estimator="ridge"))
        await server.submit(Workload(kind="permutation", dataset=spec, y=y, n_perm=14, seed=cid))

    async def main():
        async with AsyncEngineServer(engine, gather_window_ms=3.0) as server:
            await asyncio.gather(*(client(server, cid) for cid in range(8)))

    asyncio.run(main())
    assert engine.compile_count() == warm  # zero recompiles after warm-up
    assert engine.stats()["plans_built"] == 1  # warm-up built the only plan


def test_warmup_validates_arguments(problem):
    engine = _engine()
    with pytest.raises(ValueError):
        engine.warmup(_spec(problem), tasks=("nonsense",))
    with pytest.raises(ValueError):
        engine.warmup(_spec(problem), tasks=("multiclass",), num_classes=0)


# ---------------------------------------------------------------------------
# Streaming: permutation null chunks and RSA events
# ---------------------------------------------------------------------------


def test_stream_permutation_chunks_match_monolithic(problem):
    x, y, _, f = problem
    spec = DatasetSpec(x, f, LAM)
    engine = _engine()

    async def main():
        events = []
        async with AsyncEngineServer(engine, stream_chunk=8) as server:
            w = Workload(kind="permutation", dataset=spec, y=y, n_perm=20, seed=4)
            async for ev in server.stream(w):
                events.append(ev)
        return events

    events = asyncio.run(main())
    kinds = [ev.kind for ev in events]
    assert kinds[:2] == ["plan", "observed"]
    assert kinds[-1] == "done"
    null_events = [ev for ev in events if ev.kind == "null"]
    assert [ev.done for ev in null_events] == [8, 16, 20]
    assert all(isinstance(ev, ProgressEvent) and ev.total == 20 for ev in events)
    streamed_null = torch.cat([ev.payload for ev in null_events])
    final = events[-1].payload
    assert final.null.shape == (20,)
    assert torch.equal(streamed_null, final.null)
    # identical draws as the monolithic path (prefix-stable permutations)
    ref = _engine()
    _, plan = ref.plan(x, f, LAM)
    mono = ref.permutation_binary(plan, y, 20, 4)
    _close(final.null, mono.null)
    assert float(final.p) == pytest.approx(float(mono.p), abs=1e-12)


def test_stream_multiclass_permutation(problem):
    x, _, yc, f = problem
    spec = DatasetSpec(x, f, LAM)
    engine = _engine()
    req = Workload(kind="permutation", dataset=spec, y=yc, n_perm=10, seed=2,
                   estimator="multiclass", num_classes=3)

    async def main():
        async with AsyncEngineServer(engine, stream_chunk=4) as server:
            return [ev async for ev in server.stream(req)]

    events = asyncio.run(main())
    final = events[-1].payload
    ref = _engine()
    _, plan = ref.plan(x, f, LAM)
    mono = ref.permutation_multiclass(plan, yc, 10, 2, num_classes=3)
    _close(final.null, mono.null)


def test_stream_rsa_events(problem):
    x, _, yc, _ = problem
    c = 3
    spec = DatasetSpec(x, foldlib.stratified_kfold(yc, K, seed=0, device="cpu"), LAM)
    ring = rsa.ring_rdm(c, device="cpu")
    models = torch.stack([ring, ring * 0.5 + 0.1])
    engine = _engine()
    req = Workload(kind="rsa", dataset=spec, y=yc, num_classes=c,
                   model_rdms=models, n_perm=10, seed=3)

    async def main():
        async with AsyncEngineServer(engine, stream_chunk=4) as server:
            return [ev async for ev in server.stream(req)]

    events = asyncio.run(main())
    kinds = [ev.kind for ev in events]
    assert kinds[0] == "plan" and kinds[1] == "rdm" and kinds[2] == "scores"
    assert kinds[-1] == "done"
    final = events[-1].payload
    (sync,) = serve(_engine(), [req])
    for field in ("rdm", "model_scores", "null", "p"):
        _close(getattr(final, field), getattr(sync, field))


def test_stream_non_streamable_degenerates_to_done(problem):
    x, y, _, f = problem
    engine = _engine()
    req = Workload(kind="cv", dataset=DatasetSpec(x, f, LAM), y=y, estimator="binary")

    async def main():
        async with AsyncEngineServer(engine) as server:
            return [ev async for ev in server.stream(req)]

    events = asyncio.run(main())
    assert [ev.kind for ev in events] == ["done"]
    dv, _ = fastcv.binary_cv(torch.tensor(x), torch.tensor(y), f, lam=LAM)
    _close(events[0].payload.values, dv)


# ---------------------------------------------------------------------------
# Pinning: pinned plans survive cache pressure end to end
# ---------------------------------------------------------------------------


def test_pinned_plan_survives_cache_pressure(problem):
    x, _, _, f = problem
    _, probe = _engine().plan(x, f, LAM)
    engine = _engine(cache_bytes=2 * probe.nbytes + 1)
    spec = DatasetSpec(x, f, LAM)
    info = engine.warmup(spec, tasks=("binary",), buckets=(1,), pin=True)
    assert info["pinned"]
    pinned_key = info["plan_key"]
    for lam in (0.5, 2.0, 4.0, 8.0):  # pressure: 4 more plans through a 2-plan budget
        engine.plan(x, f, lam)
    assert pinned_key in engine.cache  # pinned plan never evicted
    stats = engine.stats()
    assert stats["pinned"] == 1
    assert stats["pinned_bytes"] == probe.nbytes
    assert stats["evictions"] >= 2
    # pinned bytes are excluded from pressure: unpinned usage fits the budget
    assert stats["bytes_in_use"] - stats["pinned_bytes"] <= stats["byte_budget"]
    # unpinning re-subjects the plan to LRU pressure
    assert engine.unpin(pinned_key)
    assert engine.stats()["pinned"] == 0
