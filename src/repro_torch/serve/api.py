"""Sync runners over the one-Workload API.

The serving surface is :class:`repro_torch.serve.workload.Workload` — one
versioned, eagerly-validated spec (``kind``: ``cv | permutation | rsa |
tune | grid | update``) against a registered dataset handle or an inline
:class:`~repro_torch.serve.workload.DatasetSpec`, executed by
:func:`repro_torch.serve.workload.run_workloads` and fronted by
:class:`repro_torch.serve.client.Client` (which picks the sync,
thread-queue, or asyncio transport by construction).

:func:`serve` is the synchronous batch runner: it groups workloads by
plan identity, coalesces same-plan label queries through the
:class:`~repro_torch.serve.batching.MicroBatcher` (one padded eval per
(plan, estimator, static-options) group: on CUDA one launch of each eval
kernel), and un-pads per-request results. :class:`EngineServer` wraps the
same runner in a thread-backed queue so concurrent submitters get futures
while their queries ride shared micro-batches; the asyncio counterpart
(with streamed responses) lives in :mod:`repro_torch.serve.aio`.

The reference module also answers the pre-0.1 request names it removed at
0.3 (``CVRequest`` and the like) with an ``ImportError`` that points at
its migration table. This package never had those names, so it has no
such hook: importing one is a plain ``ImportError``.

The worker thread of :class:`EngineServer` makes the engine's device its
current device before it serves (:func:`bind_engine_device`), so its
launches go to the engine's card on that card's default stream.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import torch

# reprolint: monotonic-time
# (Gather deadlines / batch_wait stamps must not jump with the wall clock.)

from repro_torch.serve.engine import CVEngine
from repro_torch.serve.trace import attach_trace, trace_of
from repro_torch.serve.workload import (  # noqa: F401  (re-exported surface)
    CVResponse,
    DatasetSpec,
    GridResponse,
    PermutationResponse,
    RSAResponse,
    TuneResponse,
    Workload,
    as_workload,
    run_workloads,
)

__all__ = [
    "DatasetSpec",
    "CVResponse",
    "PermutationResponse",
    "RSAResponse",
    "TuneResponse",
    "GridResponse",
    "serve",
    "EngineServer",
    "bind_engine_device",
]


def bind_engine_device(engine: CVEngine) -> None:
    """Make ``engine.device`` the calling thread's current CUDA device.

    A thread other than the one that built the engine starts on CUDA's
    device 0; after this call its launches (on the default stream) go to
    the engine's card. Engine worker threads call it first thing. A no-op
    for a CPU engine.
    """
    if engine.device.type == "cuda":
        torch.cuda.set_device(engine.device)


# ---------------------------------------------------------------------------
# Synchronous runner
# ---------------------------------------------------------------------------


def serve(engine: CVEngine, requests: Sequence[Workload]) -> list:
    """Serve a batch of Workloads; responses align with ``requests``.

    Thin alias of :func:`repro_torch.serve.workload.run_workloads`:
    same-plan CV label queries are coalesced into one padded eval per
    (plan, estimator, static-options) group; plans are fetched once per
    distinct dataset; ``kind="update"`` workloads against the same handle
    coalesce into one rank-k plan correction.
    """
    return run_workloads(engine, requests)


# ---------------------------------------------------------------------------
# Thread-backed queue for concurrent submitters
# ---------------------------------------------------------------------------


class EngineServer:
    """Background worker that drains a request queue into micro-batches.

    Submitters (any thread) get a Future per Workload; the worker
    collects whatever is queued — up to
    ``max_batch`` requests, waiting at most ``max_wait_ms`` after the
    first — and serves the whole batch through :func:`serve`, so
    concurrent clients' queries coalesce onto shared plans and shared
    padded evals.
    """

    # Concurrency contract, machine-checked by reprolint RL004: the served
    # counters are written by the worker thread and read by any thread;
    # they move together under _count_lock so a reader never sees a batch
    # counted without its requests.
    _GUARDED_BY = {
        "batches_served": "_count_lock",
        "requests_served": "_count_lock",
    }

    def __init__(self, engine: CVEngine, max_batch: int = 64, max_wait_ms: float = 2.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.batches_served = 0
        self.requests_served = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EngineServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="cv-engine-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        # The lock orders every in-flight submit() before the stop flag:
        # anything enqueued before the flag is visible to the worker's
        # exit condition (stop AND queue-empty), so it gets served; any
        # later submit raises instead of landing on a dead queue.
        with self._submit_lock:
            self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        while True:  # belt-and-braces: never strand a future
            try:
                _, fut = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            fut.set_exception(RuntimeError("server stopped before serving"))

    def __enter__(self) -> "EngineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client side -------------------------------------------------------

    def submit(self, request: Workload) -> Future:
        with self._submit_lock:
            if self._stop.is_set() or self._thread is None:
                raise RuntimeError("server is not running")
            # Tracing starts on the *submit* side so queue time is a real,
            # measured stage (batch_wait) instead of silently inflating
            # eval time. The trace rides the workload object across the
            # thread boundary (context vars do not).
            tracer = self.engine.tracer
            if tracer.enabled and trace_of(request) is None:
                attach_trace(request, tracer.trace())
            trace = trace_of(request)
            if trace is not None:
                trace.mark_enqueue()
            fut: Future = Future()
            self._queue.put((request, fut))
            return fut

    # -- worker side -------------------------------------------------------

    def _drain_batch(self):
        """(batch, when its first member was dequeued); ([], None) when idle."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue_mod.Empty:
            return [], None
        gathered_from = time.perf_counter()
        batch = [first]
        t_end = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue_mod.Empty:
                break
        return batch, gathered_from

    def _run(self) -> None:
        bind_engine_device(self.engine)
        while not (self._stop.is_set() and self._queue.empty()):
            batch, gathered_from = self._drain_batch()
            if not batch:
                continue
            requests = [req for req, _ in batch]
            futures = [fut for _, fut in batch]
            # One dequeue timestamp for the whole batch: every member's
            # submit->here latency is its batch_wait stage, and the gather
            # window (from the first dequeue) a gather span inside it.
            now = time.perf_counter()
            for req in requests:
                trace = trace_of(req)
                if trace is not None:
                    trace.note_dequeue(now, gathered_from)
            self.engine.metrics.observe("gather_window_occupancy", len(batch))
            try:
                # Per-entry result-or-error: one bad workload must not abort
                # sibling submitters coalesced into the same batch.
                responses = run_workloads(self.engine, requests, return_errors=True)
            except Exception as e:  # noqa: BLE001 - fanned out
                for fut in futures:
                    fut.set_exception(e)
                continue
            for fut, resp in zip(futures, responses):
                if isinstance(resp, Exception):
                    fut.set_exception(resp)
                else:
                    fut.set_result(resp)
            with self._count_lock:
                self.batches_served += 1
                self.requests_served += len(batch)
