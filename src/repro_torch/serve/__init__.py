"""repro_torch.serve — plan-cached analytical-CV serving engine, one workload API.

The paper's economics (§2.7: the hat matrix and fold factorisations depend
on features only) have the exact shape of a serving workload — expensive
label-invariant state, cheap per-request evaluation. This package serves
it on the card behind one declarative surface:

  workload  Workload — one versioned, eagerly-validated spec (kind:
            cv | permutation | rsa | tune | grid | update) against a
            registered DatasetHandle or inline DatasetSpec;
            LeastSquaresSpec — the estimator registry under which binary
            LDA, multi-class LDA, ridge, and multi-target ridge are
            registrations, not engine forks; run_workloads /
            stream_workload runners; TrafficLog.
  client    Client — submit/stream/gather over a transport chosen by
            construction (sync, thread-queue, or asyncio).
  cache     PlanCache — LRU CVPlan store under a byte budget, with
            admission control for plans larger than the whole budget and
            pin/unpin for warm, never-evicted plans.
  store     PlanStore — durable disk tier under the cache: atomic
            content-addressed plan checkpoints with integrity-verified
            loads, corrupt-entry quarantine, and byte-budget GC, in the
            reference package's layout (either package reads the other's).
  engine    CVEngine — mutable versioned dataset registry, cached plans,
            shape-bucketed evaluators from the estimator registry (on CUDA
            the hand-written kernels), RDM memoisation, and an explicit
            warmup() readiness API.
  batching  MicroBatcher — coalesce ragged same-plan label queries on the
            batch's device.
  api       serve (the sync batch runner) + EngineServer (thread-backed
            queue with futures over shared micro-batches).
  aio       AsyncEngineServer — asyncio front-end with gather-window
            micro-batching and streamed permutation/RSA/update responses,
            all engine work on one thread bound to the engine's device.
  http      HTTPEdge — the HTTP/SSE wire over the async server (Workload
            JSON in, result-or-error batches and SSE ProgressEvent streams
            out, in the reference package's wire format byte for byte),
            EdgeThread (an edge on a daemon thread), and the HTTPClient
            transport mirror; ``GET /v1/metrics`` (Prometheus text) and
            ``GET /v1/trace`` expose obs and trace.
  obs       MetricsRegistry — counters, gauges and fixed-bucket
            histograms over the request path, in Prometheus text format.
  trace     Tracer / Trace / Span — request-scoped stage timing, off by
            default (``engine.enable_tracing()``).

Entry point: ``python -m repro_torch.launch.serve_cv`` (``--http PORT``
for the network edge; ``--device cpu`` for the CPU, the card otherwise).
"""

from repro_torch.serve.aio import AsyncEngineServer  # noqa: F401
from repro_torch.serve.api import EngineServer, serve  # noqa: F401

from repro_torch.serve.batching import (  # noqa: F401
    DEFAULT_BUCKETS,
    MicroBatcher,
    as_folds,
    bucket_size,
)
from repro_torch.serve.cache import CacheStats, PlanCache  # noqa: F401
from repro_torch.serve.client import Client  # noqa: F401
from repro_torch.serve.engine import CVEngine, EngineConfig  # noqa: F401
from repro_torch.serve.http import EdgeThread, HTTPClient, HTTPEdge, WireError  # noqa: F401
from repro_torch.serve.obs import BUCKET_FAMILIES, METRICS, MetricsRegistry  # noqa: F401
from repro_torch.serve.store import SCHEMA_VERSION, PlanStore, StoreStats  # noqa: F401
from repro_torch.serve.trace import (  # noqa: F401
    NULL_TRACER,
    STAGES,
    Span,
    Trace,
    Tracer,
    attach_trace,
    trace_of,
)
from repro_torch.serve.workload import (  # noqa: F401
    KINDS,
    WORKLOAD_SCHEMA_VERSION,
    CVResponse,
    DatasetHandle,
    DatasetSpec,
    GridResponse,
    LeastSquaresSpec,
    PermutationResponse,
    ProgressEvent,
    RSAResponse,
    TrafficLog,
    TuneResponse,
    UpdateResponse,
    Workload,
    as_workload,
    estimators,
    get_estimator,
    register_estimator,
    run_workloads,
    stream_workload,
)
