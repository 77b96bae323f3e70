"""repro_torch.serve.trace — request-scoped span trees for the serving stack.

The *tracing* half of the observability layer (the metrics half lives in
:mod:`repro_torch.serve.obs`). A :class:`Trace` is one workload's span tree:
stage-named, monotonic-clock (``time.perf_counter``) intervals that cover
the request path decode → validate → plan_build/cache_lookup →
batch_wait → eval/null_chunk → encode. Finished traces land in a bounded
ring buffer on the :class:`Tracer` (read by :meth:`Tracer.last`) and
their per-stage durations feed the registry's ``stage_latency_seconds``
histogram, from which :meth:`Tracer.summary` derives per-stage p50/p95.

Propagation model
-----------------
A ``contextvars.ContextVar`` carries the *active* trace so engine-internal
instrumentation (``tracer.span("plan_build")`` deep inside
``CVEngine._build_plan``) finds the right trace without threading it
through every signature — and does so correctly under asyncio, where many
logical requests interleave on one thread.

Context vars do **not** cross thread/queue boundaries on their own
(``loop.run_in_executor`` does not copy context into the engine thread),
so cross-thread hand-off is explicit: the submit side *attaches* the
trace to the workload object (:func:`attach_trace`), and the serving side
picks it up (:func:`trace_of`) and re-activates it
(``with tracer.activate(trace):``) on whichever thread actually runs the
engine. Workload objects are frozen dataclasses, so attachment uses
``object.__setattr__``; a workload object resubmitted after its trace
finished (bench loops re-send the same objects) gets a *fresh* trace —
finished traces are never reused.

Cost model: when tracing is disabled (the default), every hook degenerates
to a shared null context manager / ``None`` checks — no clock reads, no
allocation, and no device synchronisation (``Tracer.sync`` is a no-op
without an active trace), so the card's asynchronous launch queue is
untouched.

The module is the reference package's ``serve/trace.py`` with one change:
``Tracer.sync`` waits for the CUDA devices that hold the tensors of a
value (``torch.cuda.synchronize``) where the reference blocks on jax
arrays. :data:`STAGES` equals the reference's: reprolint's RL002 checks
every span literal in ``src/`` against the reference's table.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import torch

# reprolint: monotonic-time
# (Span intervals and batch deadlines must survive wall-clock jumps;
# RL001 flags any time.time() in this module.)

__all__ = [
    "STAGES",
    "Span",
    "Trace",
    "Tracer",
    "NULL_TRACER",
    "attach_trace",
    "trace_of",
]

#: Fixed stage vocabulary — every span name must be one of these, so the
#: per-stage histogram's label set is closed (and CI can assert all of
#: them are declared in the exposition).
STAGES = (
    "decode",  # wire JSON -> workload dataclass (HTTP edge only)
    "validate",  # as_workload normalisation + workload validation
    "plan_build",  # O(N^2 P) Gram + factorisations (cache miss only)
    "plan_update",  # rank-k append/retire/window correction (kind="update")
    "cache_lookup",  # plan_key fingerprint + cache probe
    "store_load",  # disk plan-store read + integrity check (miss path)
    "batch_wait",  # submit -> dequeue latency (thread/async servers)
    "eval",  # bucketed eval (scores, RDMs, tune sweeps)
    "null_chunk",  # permutation-null chunks (monolithic or streamed)
    "encode",  # response assembly (+ wire JSON on the HTTP edge)
)

_CURRENT: "contextvars.ContextVar[Optional[Trace]]" = contextvars.ContextVar(
    "repro_serve_trace", default=None
)

_ATTR = "_obs_trace"


def attach_trace(obj, trace: "Optional[Trace]") -> None:
    """Pin a trace onto a (possibly frozen) workload object for explicit
    cross-thread hand-off. Silently a no-op for objects that reject
    attribute creation (``__slots__`` without a dict)."""
    if trace is None:
        return
    try:
        object.__setattr__(obj, _ATTR, trace)
    except (AttributeError, TypeError):
        pass


def trace_of(obj) -> "Optional[Trace]":
    """Return the live trace attached to ``obj``, or None.

    A *finished* trace is treated as absent: bench loops resubmit the
    same workload objects, and reopening a closed trace would corrupt
    both its ring entry and its histogram contribution.
    """
    trace = getattr(obj, _ATTR, None)
    if trace is not None and trace.finished:
        return None
    return trace


class Span:
    """One timed stage: offset from trace start, duration, children."""

    __slots__ = ("name", "start", "duration", "children")

    def __init__(self, name: str, start: float):
        self.name = name
        self.start = start  # seconds since trace start
        self.duration = 0.0
        self.children: list = []

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_s": self.start, "duration_s": self.duration}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class Trace:
    """One workload's span tree, built incrementally as stages run.

    ``timings()`` sums **top-level** spans only — a ``plan_build`` nested
    under another stage contributes to its parent's wall time already, and
    double-counting would break the "stage sum ≈ end-to-end duration"
    invariant the acceptance criteria (and ``tests/test_obs.py``) assert.
    """

    __slots__ = (
        "kind",
        "estimator",
        "spans",
        "duration",
        "finished",
        "_stack",
        "_t0",
        "_t_enqueue",
    )

    def __init__(self, kind: str = "", estimator: str = ""):
        self.kind = kind
        self.estimator = estimator
        self.spans: list = []  # top-level spans
        self.duration = 0.0
        self.finished = False
        self._stack: list = []  # open spans (innermost last)
        self._t0 = time.perf_counter()
        self._t_enqueue: Optional[float] = None

    # -- span construction -------------------------------------------------

    def span(self, name: str) -> "_SpanCtx":
        """Context manager timing one stage; nests under any open span."""
        return _SpanCtx(self, name)

    def add(self, name: str, seconds: float) -> Span:
        """Append an already-measured stage (e.g. a shared coalesced eval
        timed once for the whole flush group, attributed to each member)."""
        now = time.perf_counter() - self._t0
        span = Span(name, max(0.0, now - seconds))
        span.duration = seconds
        self._sink().append(span)
        return span

    def mark_enqueue(self) -> None:
        """Submit side of the batch_wait stage (thread/async servers)."""
        self._t_enqueue = time.perf_counter()

    def note_dequeue(self, now: Optional[float] = None) -> None:
        """Serving side: record submit->dequeue latency as ``batch_wait``.

        ``now`` lets a server timestamp the batch *once* and attribute the
        identical dequeue instant to every member.
        """
        if self._t_enqueue is None:
            return
        t = time.perf_counter() if now is None else now
        self.add("batch_wait", max(0.0, t - self._t_enqueue))
        self._t_enqueue = None

    def _sink(self) -> list:
        return self._stack[-1].children if self._stack else self.spans

    # -- completion --------------------------------------------------------

    def finish(self) -> None:
        if self.finished:
            return
        self.duration = time.perf_counter() - self._t0
        self.finished = True

    def timings(self) -> dict:
        """Per-stage duration sums over top-level spans, in STAGES order."""
        sums: dict = {}
        for span in self.spans:
            sums[span.name] = sums.get(span.name, 0.0) + span.duration
        return {name: sums[name] for name in STAGES if name in sums}

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "estimator": self.estimator,
            "duration_s": self.duration,
            "timings": self.timings(),
            "spans": [s.to_dict() for s in self.spans],
        }


class _SpanCtx:
    __slots__ = ("trace", "name", "_span", "_start")

    def __init__(self, trace: Trace, name: str):
        self.trace = trace
        self.name = name

    def __enter__(self) -> Span:
        self._start = time.perf_counter()
        self._span = Span(self.name, self._start - self.trace._t0)
        self.trace._sink().append(self._span)
        self.trace._stack.append(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        self._span.duration = time.perf_counter() - self._start
        if self.trace._stack and self.trace._stack[-1] is self._span:
            self.trace._stack.pop()


_NULL_CM = contextlib.nullcontext()


class _Activation:
    """Sets/resets the active-trace context var around a with-block."""

    __slots__ = ("trace", "_token")

    def __init__(self, trace: Trace):
        self.trace = trace

    def __enter__(self) -> Trace:
        self._token = _CURRENT.set(self.trace)
        return self.trace

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors reachable from ``value``."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for field in dataclasses.fields(value):
            _cuda_devices(getattr(value, field.name), out)
    elif isinstance(value, tuple):  # NamedTuples too
        for item in value:
            _cuda_devices(item, out)
    return out


class Tracer:
    """Trace factory + bounded ring of finished traces.

    Disabled by default: ``trace()`` returns None, ``span()`` returns a
    shared null context manager, ``sync()`` is a no-op — the instrumented
    request path pays only a handful of attribute checks. ``enable()``
    flips all of that on and (re)sizes the ring.
    """

    # Concurrency contract, machine-checked by reprolint RL004.
    _GUARDED_BY = {"_ring": "_lock"}

    def __init__(self, registry=None, ring: int = 256, enabled: bool = False):
        self.registry = registry
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring)))

    # -- lifecycle ---------------------------------------------------------

    def enable(self, ring: Optional[int] = None) -> None:
        if ring is not None and ring != self._ring.maxlen:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(1, int(ring)))
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @property
    def ring_size(self) -> int:
        return self._ring.maxlen

    # -- request-path hooks ------------------------------------------------

    def trace(self, kind: str = "", estimator: str = "") -> Optional[Trace]:
        """New trace when enabled, else None (callers pass it straight to
        :meth:`activate` / :func:`attach_trace`, both None-tolerant)."""
        return Trace(kind, estimator) if self.enabled else None

    def activate(self, trace: Optional[Trace]):
        """Context manager making ``trace`` the active trace; no-op CM for
        None so call sites never branch."""
        return _Activation(trace) if trace is not None else _NULL_CM

    def current(self) -> Optional[Trace]:
        return _CURRENT.get()

    def span(self, name: str):
        """Time one stage on the *active* trace (null CM when none)."""
        trace = _CURRENT.get()
        return trace.span(name) if trace is not None else _NULL_CM

    def sync(self, value):
        """Wait for the card **only when a trace is active** — span
        durations must measure compute, not launch enqueue time; without a
        trace the launch queue stays untouched. Synchronises each CUDA
        device holding a tensor of ``value`` (a tensor, a ``CVPlan`` or
        another dataclass, a NamedTuple or tuple of them); CPU tensors
        need no wait."""
        if _CURRENT.get() is not None and value is not None:
            for device in _cuda_devices(value, set()):
                torch.cuda.synchronize(device)
        return value

    # -- completion / exposition -------------------------------------------

    def finish(self, trace: Optional[Trace]) -> None:
        """Close a trace: stamp duration, ring-append, feed histograms."""
        if trace is None or trace.finished:
            return
        trace.finish()
        with self._lock:
            self._ring.append(trace)
        if self.registry is not None and "stage_latency_seconds" in self.registry:
            for stage, seconds in trace.timings().items():
                self.registry.observe("stage_latency_seconds", seconds, stage=stage)

    def last(self, n: int = 32) -> list:
        """Newest-first dicts of the last ``n`` finished traces."""
        with self._lock:
            traces = list(self._ring)
        return [t.to_dict() for t in reversed(traces[-max(0, int(n)) :])]

    def summary(self) -> dict:
        """Per-stage ``{count, p50_s, p95_s}`` over the current ring."""
        with self._lock:
            traces = list(self._ring)
        by_stage: dict = {}
        for t in traces:
            for stage, seconds in t.timings().items():
                by_stage.setdefault(stage, []).append(seconds)
        out = {}
        for stage in STAGES:
            vals = by_stage.get(stage)
            if not vals:
                continue
            vals.sort()
            out[stage] = {
                "count": len(vals),
                "p50_s": vals[len(vals) // 2],
                "p95_s": vals[min(len(vals) - 1, int(len(vals) * 0.95))],
            }
        return out


#: Shared fallback so call sites can write
#: ``tracer = getattr(engine, "tracer", None) or NULL_TRACER`` and never
#: branch again — a disabled Tracer's hooks are all no-ops.
NULL_TRACER = Tracer()
