"""repro_torch.serve.aio — asyncio front-end over the CV engine.

The sync runners in :mod:`repro_torch.serve.api` make one of two trades:
the blocking :func:`~repro_torch.serve.api.serve` wants the whole batch up
front, and the thread-queue :class:`~repro_torch.serve.api.EngineServer`
gives each submitter a `concurrent.futures.Future` but keeps long work
monolithic — one slow permutation workload head-of-line-blocks every
cheap binary query behind it. This module turns the engine into a
traffic-shaped service:

* :class:`AsyncEngineServer` — submitters ``await server.submit(w)`` (a
  :class:`~repro_torch.serve.workload.Workload`) from any coroutine; the
  worker gathers whatever arrives inside a deadline-bounded window
  (``gather_window_ms`` after the first request, up to ``max_batch``) and
  serves the whole group through the sync runner, so same-plan traffic
  still coalesces through the engine's
  :class:`~repro_torch.serve.batching.MicroBatcher` into one padded eval
  per flush group. Engine compute runs on a single executor thread; the
  event loop never blocks on the card.
* **Streaming** — ``server.stream(w)`` returns an async iterator of
  :class:`~repro_torch.serve.workload.ProgressEvent`\\ s for long-running
  work: permutation workloads emit their null distribution in
  prefix-stable chunks (running p-values for free), RSA workloads emit the
  empirical RDM, then model scores, then permutation-null chunks. The
  event sequence is produced by the *one* streaming implementation —
  :func:`repro_torch.serve.workload.stream_workload` — driven chunk by
  chunk on the engine's executor thread, so a stream interleaves with
  batch traffic at chunk granularity and never adds a launch shape after
  warm-up.

The streamed permutations are the same draws the monolithic path uses
(``permutation_indices`` is prefix-stable under bucket rounding), so a
stream's final ``done`` payload matches the one-shot response up to
padded-shape rounding (on the CPU bit for bit; on the card, bit for bit
where the chunk equals the monolithic bucket).

The executor thread makes the engine's device current before its first
task (:func:`~repro_torch.serve.api.bind_engine_device`): every kernel
launch of a served batch or stream chunk is issued from that one thread,
on the engine card's default stream.
"""

from __future__ import annotations

import asyncio
import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Optional

# reprolint: monotonic-time
# (Gather-window deadlines and batch_wait stamps must not jump with the
# wall clock — loop.time()/perf_counter only in this module.)

from repro_torch.serve.api import bind_engine_device
from repro_torch.serve.engine import CVEngine
from repro_torch.serve.trace import attach_trace, trace_of
from repro_torch.serve.workload import ProgressEvent, as_workload, run_workloads, stream_workload

__all__ = ["ProgressEvent", "AsyncEngineServer"]

_STOP = object()
_STREAM_END = object()


class AsyncEngineServer:
    """Asyncio server: gather-window micro-batching + streaming workloads.

    Submitters get one coroutine per workload (``await submit(w)``);
    concurrent submissions landing within ``gather_window_ms`` of each
    other coalesce onto shared plans and shared padded evals exactly like
    the sync runner. ``stream(w)`` yields
    :class:`~repro_torch.serve.workload.ProgressEvent`\\ s for
    permutation/RSA workloads instead of one monolithic response, chunked
    by ``stream_chunk`` (canonicalised to an engine shape bucket).
    """

    # Concurrency contract, machine-checked by reprolint RL004. The map
    # is deliberately empty: every mutable attribute here is confined to
    # the event loop (submit/stream/worker are coroutines; engine calls
    # hop to the executor but mutate only engine state, which carries its
    # own _GUARDED_BY).
    _GUARDED_BY = {}

    def __init__(
        self,
        engine: CVEngine,
        max_batch: int = 64,
        gather_window_ms: float = 2.0,
        stream_chunk: int = 64,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.gather_window_s = gather_window_ms / 1e3
        self.stream_chunk = stream_chunk
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queue: Optional[asyncio.Queue] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._worker_task: Optional[asyncio.Task] = None
        self._stopping = False
        self.batches_served = 0
        self.requests_served = 0
        self.streams_served = 0

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "AsyncEngineServer":
        if self._worker_task is not None:
            raise RuntimeError("server already started")
        self._loop = asyncio.get_running_loop()
        self._queue = asyncio.Queue()
        # One engine thread, bound to the engine's device: the event loop
        # never blocks on the card, and batch evals / stream chunks
        # interleave fairly at task granularity.
        self._executor = ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix="cv-engine-aio",
            initializer=bind_engine_device,
            initargs=(self.engine,),
        )
        self._stopping = False
        self._worker_task = self._loop.create_task(self._worker())
        return self

    async def stop(self) -> None:
        if self._worker_task is None:
            return
        self._stopping = True
        self._queue.put_nowait(_STOP)
        await self._worker_task
        self._worker_task = None
        while not self._queue.empty():  # belt-and-braces: never strand a future
            item = self._queue.get_nowait()
            if item is not _STOP:
                _, fut = item
                if not fut.done():
                    fut.set_exception(RuntimeError("server stopped before serving"))
        self._executor.shutdown(wait=True)
        self._executor = None
        # Write-behind plan saves must land before the process can exit —
        # a SIGTERM'd replica's last builds are next boot's store hits.
        # (Each pending save already owns a host copy of its plan.)
        self.engine.flush_store()

    async def __aenter__(self) -> "AsyncEngineServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def _check_running(self) -> None:
        if self._worker_task is None or self._stopping:
            raise RuntimeError("server is not running")

    def _run(self, fn, *args, **kw):
        """Run one engine call on the executor thread; await the result.

        Guarded so a stream outliving :meth:`stop` fails fast instead of
        silently falling back to the loop's default (multi-thread)
        executor — which would break the single-engine-thread invariant.
        """
        if self._executor is None:
            raise RuntimeError("server is not running")
        return self._loop.run_in_executor(self._executor, functools.partial(fn, *args, **kw))

    # -- client side -------------------------------------------------------

    async def submit(self, request):
        """Submit one workload; awaits its response."""
        self._check_running()
        # Trace from the submit side so gather-window queue time is a
        # measured batch_wait stage; the trace rides the workload object
        # onto the engine thread (run_in_executor does not copy context).
        tracer = self.engine.tracer
        if tracer.enabled and trace_of(request) is None:
            attach_trace(request, tracer.trace())
        trace = trace_of(request)
        if trace is not None:
            trace.mark_enqueue()
        fut = self._loop.create_future()
        await self._queue.put((request, fut))
        return await fut

    async def register(self, x, folds, lam: float, mode: str = "auto"):
        """Register a dataset on the engine thread; returns its handle.

        Fingerprinting copies the features to the host and hashes them, so
        it runs on the executor like every other engine touch — the event
        loop never blocks on a large registration (the HTTP edge's ``POST
        /v1/datasets`` route lands here).
        """
        self._check_running()
        return await self._run(self.engine.register, x, folds, lam, mode=mode)

    async def append(self, handle, x_new=None, *, drop_idx=None, folds_delta=None):
        """Advance a registered dataset on the engine thread; returns the
        version n+1 handle (the ``POST /v1/datasets/{fp}/append`` route
        lands here). Append, retire, or slide per the arguments — thin
        passthrough to :meth:`CVEngine.update_dataset`."""
        self._check_running()
        return await self._run(
            self.engine.update_dataset,
            handle,
            x_new=x_new,
            drop_idx=drop_idx,
            folds_delta=folds_delta,
        )

    async def stream(self, request) -> AsyncIterator[ProgressEvent]:
        """Async iterator of :class:`ProgressEvent`\\ s for one workload.

        Permutation, RSA, and update workloads stream incrementally by
        driving :func:`~repro_torch.serve.workload.stream_workload` on the
        engine thread (updates emit one event per applied increment); any
        other kind degenerates to a single "done" event wrapping the
        batched response (counted in ``streams_served`` either way —
        streams count when they start, so abandoned iterators count too).
        """
        self._check_running()
        self.streams_served += 1
        w = as_workload(request)
        if w.kind not in ("permutation", "rsa", "update"):
            yield ProgressEvent("done", 1, 1, await self.submit(w))
            return
        gen = stream_workload(self.engine, w, chunk=self.stream_chunk)
        while True:
            event = await self._run(next, gen, _STREAM_END)
            if event is _STREAM_END:
                return
            yield event

    # -- worker side -------------------------------------------------------

    async def _worker(self) -> None:
        while True:
            item = await self._queue.get()
            if item is _STOP:
                # Serve anything that raced in behind the sentinel, then exit.
                leftovers = []
                while not self._queue.empty():
                    nxt = self._queue.get_nowait()
                    if nxt is not _STOP:
                        leftovers.append(nxt)
                if leftovers:
                    await self._serve_batch(leftovers)
                return
            gathered_from = time.perf_counter()
            batch = [item]
            deadline = self._loop.time() + self.gather_window_s
            while len(batch) < self.max_batch:
                remaining = deadline - self._loop.time()
                if remaining <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), remaining)
                except asyncio.TimeoutError:
                    break
                if nxt is _STOP:
                    self._queue.put_nowait(_STOP)  # re-post; exit after this batch
                    break
                batch.append(nxt)
            await self._serve_batch(batch, gathered_from)

    async def _serve_batch(self, batch, gathered_from=None) -> None:
        requests = [req for req, _ in batch]
        futures = [fut for _, fut in batch]
        # One dequeue timestamp for the whole gather window: each member's
        # submit->here latency becomes its batch_wait stage, and the window
        # itself (from its first dequeue) a gather span inside it.
        now = time.perf_counter()
        for req in requests:
            trace = trace_of(req)
            if trace is not None:
                trace.note_dequeue(now, gathered_from)
        self.engine.metrics.observe("gather_window_occupancy", len(batch))
        try:
            # Per-entry result-or-error: a malformed workload (or an
            # unknown/evicted dataset handle) fails only its own future,
            # never sibling submitters sharing the gather window.
            responses = await self._run(run_workloads, self.engine, requests, return_errors=True)
        except Exception as e:  # noqa: BLE001 - fanned out to submitters
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
            return
        for fut, resp in zip(futures, responses):
            if not fut.done():
                if isinstance(resp, Exception):
                    fut.set_exception(resp)
                else:
                    fut.set_result(resp)
        self.batches_served += 1
        self.requests_served += len(batch)
