"""repro_torch.serve.client — one Client, three transports.

Every entry point in this package executes the same
:class:`~repro_torch.serve.workload.Workload` spec through the same engine; the
only real choice a caller makes is *how submissions travel*: inline on
the calling thread, through the thread-backed queue, or through the
asyncio gather window. :class:`Client` makes that a constructor argument
instead of three APIs:

    client = Client(engine)                      # sync, in-process
    client = Client(engine, transport="thread")  # EngineServer futures
    client = Client(engine, transport="async")   # AsyncEngineServer

``submit`` / ``gather`` / ``stream`` then have transport-appropriate
return types (response vs Future vs awaitable; generator vs async
generator) but identical semantics and — by the parity tests —
bit-identical results on the CPU (on the card, bit-identical where the
transports coalesce the same workloads into the same bucket widths).
``Client()`` builds its own ``CVEngine()``, which takes the card and
raises without one; pass ``Client(CVEngine(EngineConfig(device="cpu")))``
for the CPU. The client also fronts the engine's dataset
registry (``register`` → :class:`~repro_torch.serve.workload.DatasetHandle`)
and, given a :class:`~repro_torch.serve.workload.TrafficLog`, records the
(task, bucket) set of everything submitted so a later boot can warm the
engine from observed traffic (``serve_cv --record-traffic`` /
``--warmup-from``).
"""

from __future__ import annotations

import asyncio
from typing import Optional, Sequence

from repro_torch.serve.aio import AsyncEngineServer
from repro_torch.serve.api import EngineServer
from repro_torch.serve.engine import CVEngine
from repro_torch.serve.workload import (
    DatasetHandle,
    TrafficLog,
    as_workload,
    run_workloads,
    stream_workload,
)

__all__ = ["Client"]

_TRANSPORTS = ("sync", "thread", "async")


class Client:
    """Unified front door: submit/stream/gather over a chosen transport.

    transport="sync"    ``submit`` returns the response, ``gather`` the
                        response list (whole batch coalesced through one
                        runner call), ``stream`` a plain generator.
    transport="thread"  ``submit`` returns a ``concurrent.futures.Future``
                        from a lazily-started
                        :class:`~repro_torch.serve.api.EngineServer`; ``gather``
                        blocks for all results; ``stream`` runs on the
                        calling thread (the engine is thread-safe, so
                        chunks interleave with the worker's batches).
    transport="async"   use ``async with Client(...)``; ``submit`` /
                        ``gather`` are awaitables and ``stream`` an async
                        iterator over an
                        :class:`~repro_torch.serve.aio.AsyncEngineServer`.
    """

    def __init__(
        self,
        engine: Optional[CVEngine] = None,
        transport: str = "sync",
        *,
        max_batch: int = 64,
        gather_window_ms: float = 2.0,
        stream_chunk: int = 64,
        record: Optional[TrafficLog] = None,
    ):
        if transport not in _TRANSPORTS:
            raise ValueError(f"transport must be one of {_TRANSPORTS}, got {transport!r}")
        self.engine = engine if engine is not None else CVEngine()
        self.transport = transport
        self.max_batch = max_batch
        self.gather_window_ms = gather_window_ms
        self.stream_chunk = stream_chunk
        self.record = record
        self._server = None  # EngineServer | AsyncEngineServer | None

    # -- dataset registry passthrough --------------------------------------

    def register(self, x, folds, lam: float, mode: str = "auto") -> DatasetHandle:
        """Register a dataset once; subsequent workloads carry the handle."""
        return self.engine.register(x, folds, lam, mode=mode)

    def datasets(self) -> tuple:
        return self.engine.datasets()

    def append(self, handle: DatasetHandle, x_new, folds_delta=None) -> DatasetHandle:
        """Append rows to a registered dataset; returns the version n+1
        handle (the old version stays servable until released)."""
        return self.engine.append(handle, x_new, folds_delta=folds_delta)

    def retire(self, handle: DatasetHandle, idx) -> DatasetHandle:
        """Retire rows of a registered dataset; returns the version n+1
        handle."""
        return self.engine.retire(handle, idx)

    def warmup(self, dataset, **kwargs) -> dict:
        return self.engine.warmup(dataset, **kwargs)

    # -- submission --------------------------------------------------------

    def _note(self, w, stream_chunk: Optional[int] = None) -> None:
        if self.record is not None:
            self.record.record(w, self.engine.config.buckets, stream_chunk=stream_chunk)

    def submit(self, workload):
        """One workload in; transport-appropriate handle out
        (response / Future / awaitable)."""
        w = as_workload(workload)
        self._note(w)
        if self.transport == "sync":
            (resp,) = run_workloads(self.engine, [w])
            return resp
        if self.transport == "thread":
            return self._thread_server().submit(w)
        return self._async_server().submit(w)

    def gather(self, workloads: Sequence, *, return_errors: bool = False):
        """Submit a batch; return (or await) the aligned response list.

        The sync transport coalesces the whole batch through one runner
        call (maximal micro-batching); thread/async submit individually so
        the batch interleaves with other clients' traffic.

        With ``return_errors=True`` a failing workload yields its
        exception object in the corresponding slot instead of aborting the
        batch: sibling workloads still get real responses. The default
        (``False``) keeps raise-on-first-error semantics.
        """
        conv: list = []
        for w in workloads:
            try:
                wl = as_workload(w)
                self._note(wl)
                conv.append(wl)
            except Exception as e:  # noqa: BLE001 - surfaced per entry
                if not return_errors:
                    raise
                conv.append(e)
        live = [(i, w) for i, w in enumerate(conv) if not isinstance(w, Exception)]
        results = list(conv)  # conversion errors stay in their slots

        if self.transport == "sync":
            out = run_workloads(self.engine, [w for _, w in live], return_errors=return_errors)
            for (i, _), r in zip(live, out):
                results[i] = r
            return results
        if self.transport == "thread":
            futures = [(i, self._thread_server().submit(w)) for i, w in live]
            for i, f in futures:
                if return_errors:
                    e = f.exception()
                    results[i] = e if e is not None else f.result()
                else:
                    results[i] = f.result()
            return results

        async def _gather():
            server = self._async_server()
            out = await asyncio.gather(
                *(server.submit(w) for _, w in live), return_exceptions=return_errors
            )
            for (i, _), r in zip(live, out):
                results[i] = r
            return results

        return _gather()

    def stream(self, workload):
        """Progress events for one workload: a generator (sync/thread
        transports) or an async iterator (async transport)."""
        w = as_workload(workload)
        self._note(w, stream_chunk=self.stream_chunk)
        if self.transport == "async":
            return self._async_server().stream(w)
        return stream_workload(self.engine, w, chunk=self.stream_chunk)

    # -- lifecycle ---------------------------------------------------------

    def _thread_server(self) -> EngineServer:
        if self._server is None:
            self._server = EngineServer(
                self.engine, max_batch=self.max_batch, max_wait_ms=self.gather_window_ms
            ).start()
        return self._server

    def _async_server(self) -> AsyncEngineServer:
        if self._server is None:
            raise RuntimeError(
                "async Client must be entered first: `async with Client(engine, "
                "transport='async') as client:`"
            )
        return self._server

    def close(self) -> None:
        if self.transport == "thread" and self._server is not None:
            self._server.stop()
            self._server = None

    def __enter__(self) -> "Client":
        if self.transport == "async":
            raise RuntimeError("async Client needs `async with`, not `with`")
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    async def __aenter__(self) -> "Client":
        if self.transport != "async":
            raise RuntimeError(f"`async with` needs transport='async', not {self.transport!r}")
        self._server = await AsyncEngineServer(
            self.engine,
            max_batch=self.max_batch,
            gather_window_ms=self.gather_window_ms,
            stream_chunk=self.stream_chunk,
        ).start()
        return self

    async def __aexit__(self, *exc) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None

    # -- observability -----------------------------------------------------

    @property
    def server(self):
        """The backing server (None for the sync transport)."""
        return self._server

    def stats(self) -> dict:
        return self.engine.stats()

    def metrics(self):
        """The engine's :class:`~repro_torch.serve.obs.MetricsRegistry` (live view)."""
        return self.engine.metrics

    def trace_summary(self) -> dict:
        """Per-stage {count, p50_s, p95_s} over the tracer's ring buffer."""
        return self.engine.tracer.summary()
