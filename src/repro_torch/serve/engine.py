"""CVEngine: plan-cached, shape-bucketed analytical-CV evaluation.

The engine is the multi-tenant core of ``repro_torch.serve``. It owns

  * a :class:`~repro_torch.serve.cache.PlanCache` — one
    :class:`~repro_torch.core.fastcv.CVPlan` per (dataset × folds × λ ×
    mode), LRU-evicted under a byte budget, so repeated requests against
    the same features never re-factorise — optionally backed by a durable
    :class:`~repro_torch.serve.store.PlanStore` tier (``plan_store``
    config): cache misses read-through from disk before rebuilding, fresh
    builds persist write-behind (``save_plans``), so a restarted replica
    warm-boots with zero plan builds;
  * a **dataset registry** — :meth:`CVEngine.register` fingerprints a
    dataset once and returns a
    :class:`~repro_torch.serve.workload.DatasetHandle`; workloads carry
    the handle instead of re-shipping the feature matrix, evicted plans
    rebuild transparently, and :meth:`datasets` exposes residency /
    pinning / traffic per registration. The registry is *mutable and
    versioned*: :meth:`append` / :meth:`retire` / :meth:`update_dataset`
    advance a dataset to a version n+1 handle by rank-k plan correction
    (:func:`repro_torch.core.fastcv.update_plan`), while version n stays
    servable — in-flight workloads pin it (:meth:`retain_version`) —
    until :meth:`release`;
  * the CV *evaluators*, drawn from the least-squares **estimator
    registry** (:mod:`repro_torch.serve.workload`): one per (eval family ×
    static options), created lazily but exactly once per engine. Binary
    LDA, multi-class LDA, ridge, and multi-target ridge are
    registrations; :meth:`eval_estimator` serves any newly registered
    model with zero engine changes. Permutation-null metrics and RSA
    scoring keep their own families;
  * an **RDM memo** (:class:`repro_torch.rsa.rdm.RDMCache`): empirical
    RDMs keyed by (plan, labels fingerprint), so repeat model scoring
    against the same data skips the fold solves (``stats()["rdm_hits"]``);
  * *shape buckets* for the label-batch dimension: every batch is padded
    up to a static bucket size before it reaches the eval route, so an
    engine serving ragged traffic launches its kernels at no more than
    ``len(buckets)`` batch widths per eval path.

How this package differs from the reference's ``serve/engine.py``:

  * **Device.** ``EngineConfig.device=None`` means ``cuda`` and raises
    without a card (``kernels.common.resolve_device``); tests pass
    ``device="cpu"``. Every tensor the engine creates is made on its
    device — identity permutations, padding, permutation draws — and
    every input it is handed is moved there. The device alone picks the
    eval route (``kernels.common.default_fused``): the kernels on CUDA,
    the Cholesky composite on the CPU (the composite stays reachable on
    any device through the ``core`` functions' ``fused=False``). Plan
    builds take the ``gram`` kernel on CUDA through ``fastcv.prepare``.
  * **The compile-count contract.** The engine runs eagerly: no
    ``torch.compile``, no CUDA graphs. Each cached evaluator is a small
    :class:`_Evaluator` that records the distinct input signatures it has
    served — shapes, dtypes and devices of its tensors, and whether the
    plan has its train block. :meth:`compile_count` sums them, so the
    reference's invariant (flat after a warm-up that covers the traffic's
    buckets) holds unchanged and counts distinct kernel launch shapes.
  * **No knobs that select nothing.** The reference's ``donate`` /
    ``set_donate``, ``gram_impl`` and ``fused`` have no counterpart:
    eager PyTorch never aliases a caller's tensor into an output, the
    Gram route follows the tensor's device, and so does the eval route.
  * **Fingerprints.** Tensors are mutable, so ``fastcv.fingerprint``
    memoises nothing and copies X to the host. :meth:`register` mints the
    plan key once; resolving a handle reuses the key kept in the registry
    and never hashes X again. Inline specs are hashed per request, as in
    the reference.
  * **RNG.** Permutations are drawn from an integer seed by
    ``core.permutation.permutation_indices``, not by ``jax.random``: one
    ``permdraw`` launch for all rows of a request (Fisher–Yates on
    Philox4x32-10 words, Lemire's bounded integers with rejection),
    prefix-stable, and the same rows on every device.
  * **Meshes.** ``EngineConfig.mesh`` takes a
    ``torch.distributed.device_mesh.DeviceMesh`` on the engine's device
    type, with ``feature_axis`` and ``perm_axes`` naming its dims. A mesh
    engine builds dual plans through
    :func:`repro_torch.core.distributed.distributed_gram` (the reference's
    ``gram_impl="distributed"``; a feature axis of size 1 is the
    reference's mesh with a local Gram, so there is no ``gram_impl``), and
    :meth:`null_binary` shards each permutation batch over ``perm_axes``
    through ``sharded_null_from_plan`` (padded with edge rows to a whole
    number of shards, trimmed back), so ``permutation_binary`` and
    ``workload.stream_workload`` take the mesh as the reference's do. A
    mesh engine is a collective: every rank of the mesh runs its own
    engine and serves the same traffic in the same order (see
    ``core.distributed``). The edges (``api``, ``aio``, ``http``,
    ``launch.serve_cv``) carry a mesh engine at world size 1, one card's
    case; ``serve_cv`` has no mesh flag, as the reference's has none.

:meth:`CVEngine.warmup` turns the lazy caches into an explicit readiness
API: it pre-builds (and optionally pins) the plan for a dataset spec and
serves the bucketed eval family once per bucket, so first real traffic
hits zero plan builds and zero new launch shapes. The chunk-level
``observed_*`` / ``null_*`` methods expose the permutation machinery at
sub-request granularity (``workload.stream_workload`` drives them).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import distributed, fastcv, metrics, multiclass, tuning
from repro_torch.core import permutation as perm_lib
from repro_torch.core.folds import Folds
from repro_torch.kernels.common import default_fused, resolve_device
from repro_torch.rsa import compare as rsa_compare
from repro_torch.rsa import rdm as rsa_rdm
from repro_torch.serve.batching import DEFAULT_BUCKETS, MicroBatcher, as_folds, bucket_size
from repro_torch.serve.cache import PlanCache
from repro_torch.serve.obs import BUCKET_FAMILIES, METRICS, MetricsRegistry
from repro_torch.serve.store import PlanStore
from repro_torch.serve.trace import STAGES, Tracer
from repro_torch.serve.workload import (DatasetHandle, _rdm_p_value, _synchronize, _tensor,
                                        get_estimator)

__all__ = ["EngineConfig", "CVEngine", "DatasetHandle"]

_PRECISIONS = ("fp32", "bf16_gram")  # mirrors repro_torch.kernels.gram.ops
_WARMUP_TASKS = ("binary", "ridge", "multiclass", "permutation", "rsa")


def _signature(a):
    """What a launch's shape depends on: tensors' shapes, dtypes and devices,
    a plan's leaves (None for an absent train block), other values as is."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype), a.device.type)
    if isinstance(a, fastcv.CVPlan):
        return tuple(_signature(getattr(a, name)) for name in fastcv.PLAN_FIELDS)
    return a


def _non_finite(out) -> bool:
    """True if any floating tensor in ``out`` (a tensor or a tuple of
    them) holds a NaN or an infinity; one host sync per tensor."""
    parts = out if isinstance(out, (tuple, list)) else (out,)
    return any(isinstance(t, torch.Tensor) and t.is_floating_point()
               and not bool(torch.isfinite(t).all()) for t in parts)


class _Evaluator:
    """One eval path and the distinct input signatures it has served.

    The eager counterpart of the reference's per-path jit cache: a
    signature is recorded where a jitted program would have been traced,
    so ``len(signatures)`` is what ``fn._cache_size()`` counts there.
    (``set.add`` is atomic under the interpreter lock.) With the engine's
    ``debug_nans`` set, each call's outputs are checked for NaN and ±inf,
    and a bad one raises ``FloatingPointError`` naming the evaluator (the
    counterpart of the reference's ``jax_debug_nans``; the check syncs the
    host, so it is off by default).
    """

    __slots__ = ("fn", "signatures", "name", "engine")

    def __init__(self, fn, name: str, engine):
        self.fn = fn
        self.signatures: set = set()
        self.name = name
        self.engine = engine

    def __call__(self, *args):
        self.signatures.add(tuple(_signature(a) for a in args))
        out = self.fn(*args)
        if self.engine.debug_nans and _non_finite(out):
            raise FloatingPointError(f"evaluator {self.name} produced a NaN or an infinity")
        return out


@dataclasses.dataclass
class _DatasetRecord:
    """Registry entry behind a :class:`DatasetHandle`.

    Keeps the actual feature matrix (on the engine's device) and folds so
    plans evicted under cache pressure can be rebuilt from the handle
    alone — clients never re-ship the bytes. ``handle.key`` is the plan
    key minted once at registration (or update); resolving the handle
    reuses it instead of fingerprinting ``x`` again.

    ``version``/``n_appended`` mirror the handle (the registry is the
    source of truth for the mutable-dataset lineage). ``refs`` counts
    in-flight workload batches pinning this version
    (:meth:`CVEngine.retain_version`); ``retired`` marks a version whose
    :meth:`CVEngine.release` was deferred until those refs drain.
    """

    handle: DatasetHandle
    x: torch.Tensor
    folds: Folds
    lam: float
    mode: str
    served: int = 0
    last_used: float = 0.0  # wall-clock (time.time) — display only, never a deadline
    version: int = 0
    n_appended: int = 0
    refs: int = 0
    retired: bool = False
    drop_store: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs.

    cache_bytes: PlanCache byte budget (device bytes of the plans).
    precision:   Gram build precision: "fp32" (default) or "bf16_gram"
                 (dual-mode Gram from bf16 inputs with f32 accumulation,
                 all solves full precision). Part of the plan key.
    buckets:     static label-batch sizes; ragged batches pad up to these.
    plan_store:  optional directory for the durable plan tier
                 (:class:`repro_torch.serve.store.PlanStore`): cache misses
                 try a verified disk read before the O(N²P) rebuild.
    save_plans:  with ``plan_store``: write-behind every freshly built
                 plan to the store (off = read-only warm-boot tier).
    store_bytes: plan-store byte budget (GC evicts oldest entries over
                 it, never those pinned in the in-memory cache).
    device:      where plans, batches and results live; None = "cuda"
                 (raises without a card), "cpu" for the plain versions.
    mesh:        optional ``DeviceMesh`` on the engine's device type:
                 dual plans from the feature-sharded Gram, permutation
                 batches sharded over the mesh (a collective engine).
    feature_axis / perm_axes: the mesh dims of the feature-sharded Gram
                 and of the permutation shards; both must be in the mesh.
    """

    cache_bytes: int = 512 << 20
    precision: str = "fp32"
    buckets: Sequence[int] = DEFAULT_BUCKETS
    plan_store: Optional[str] = None
    save_plans: bool = False
    store_bytes: int = 4 << 30
    device: Optional[object] = None
    mesh: Optional[object] = None
    feature_axis: str = "model"
    perm_axes: tuple = ("data",)

    def __post_init__(self):
        if self.save_plans and not self.plan_store:
            raise ValueError("save_plans=True requires a plan_store directory")
        if self.precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}")
        if self.mesh is not None:
            if self.precision != "fp32":
                raise ValueError(
                    "precision='bf16_gram' is not supported with a mesh (the "
                    "feature-sharded reduction has no mixed-precision path)")
            names = tuple(self.mesh.mesh_dim_names or ())
            missing = [a for a in (self.feature_axis, *self.perm_axes) if a not in names]
            if missing:
                raise ValueError(f"mesh dims {names} lack the axes {missing}")


class CVEngine:
    """Multi-tenant analytical-CV evaluation engine."""

    # Concurrency contract, machine-checked by reprolint RL004: several
    # threads may drive one engine, so the lifetime stat counters
    # increment under _lock — a lost `+= b` here silently skews capacity
    # accounting.
    _GUARDED_BY = {
        "plans_built": "_lock",
        "plans_updated": "_lock",
        "labels_evaluated": "_lock",
    }

    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        if self.device.type == "cuda" and self.device.index is None:
            # one spelling of the device, so tensors already there compare equal
            self.device = torch.device("cuda", torch.cuda.current_device())
        mesh = self.config.mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the engine on "
                             f"{self.device.type}")
        self.cache = PlanCache(self.config.cache_bytes)
        self.store = (
            PlanStore(self.config.plan_store, byte_budget=self.config.store_bytes,
                      device=self.device)
            if self.config.plan_store
            else None
        )
        self.rdm_cache = rsa_rdm.RDMCache()
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(registry=self.metrics)
        self._declare_metrics()
        self.batcher = MicroBatcher(self.config.buckets, metrics=self.metrics)
        # the kernels on CUDA, the Cholesky composite on the CPU
        self._fused = default_fused(self.device)
        # Evaluators are created lazily but exactly once per static
        # signature and held forever: their recorded input signatures are
        # what compile_count() sums. CV evals come from the least-squares
        # estimator registry (repro_torch.serve.workload): one evaluator per
        # (eval_key, static options) — registered estimators sharing an
        # eval_key (ridge / ridge_multi) share it.
        self._evals = {}  # (eval_key, static opts) -> _Evaluator
        self._perm_binary = {}  # (metric, adjust_bias) -> _Evaluator -> (B,)
        self._perm_multiclass = {}  # num_classes -> _Evaluator -> (B,)
        self._rsa_pairs = {}  # (dissim, adjust_bias) -> _Evaluator
        self._rsa_score = {}  # method -> _Evaluator[(emp, models) -> (M,)]
        self._rsa_null = {}  # method -> _Evaluator[(emp, models, perms) -> (M,T)]
        self._datasets = {}  # handle key -> _DatasetRecord
        # guards the stat counters below and each version's served / refs
        self._lock = threading.Lock()
        self.plans_built = 0
        self.plans_updated = 0
        self.labels_evaluated = 0
        # raise FloatingPointError on a non-finite eval output (syncs the host)
        self.debug_nans = False

    def _declare_metrics(self) -> None:
        """Register the central :data:`repro_torch.serve.obs.METRICS` table.

        The table is the single declaration of every metric name, kind
        and label-key set (reprolint RL003 checks call sites against it);
        this method contributes only *behavior*: the callback behind each
        gauge. Cache / evaluator / memo health is exported through callback
        gauges over the existing counters — the registry is a view, never
        a second copy. Stage histograms get every stage label pre-declared
        so the exposition lists the full vocabulary before any traffic.
        """
        m = self.metrics
        gauge_sources = {
            "plan_cache_hits": lambda: self.cache.stats.hits,
            "plan_cache_misses": lambda: self.cache.stats.misses,
            "plan_cache_evictions": lambda: self.cache.stats.evictions,
            "plan_cache_oversized": lambda: self.cache.stats.oversized,
            "plan_cache_bytes_in_use": lambda: self.cache.stats.bytes_in_use,
            "plan_store_hits": lambda: self.store.stats.hits if self.store else 0,
            "plan_store_misses": lambda: self.store.stats.misses if self.store else 0,
            "plan_store_writes": lambda: self.store.stats.writes if self.store else 0,
            "plan_store_bytes": lambda: self.store.stats.bytes_in_store if self.store else 0,
            "compile_events": self.compile_count,
            "rdm_hits": lambda: self.rdm_cache.hits,
            "plans_built": lambda: self.plans_built,
            "plans_updated": lambda: self.plans_updated,
            "labels_evaluated": lambda: self.labels_evaluated,
            "datasets_registered": lambda: len(self._datasets),
        }
        for name, spec in METRICS.items():
            kind = spec["kind"]
            if kind == "counter":
                m.counter(name, spec["help"], labels=spec["labels"])
            elif kind == "histogram":
                m.histogram(
                    name,
                    spec["help"],
                    buckets=BUCKET_FAMILIES[spec["buckets"]],
                    labels=spec["labels"],
                )
            else:
                # KeyError here means METRICS declares a gauge this engine
                # supplies no callback for — fail at construction, loudly.
                m.gauge(name, spec["help"], fn=gauge_sources.pop(name))
        if gauge_sources:
            raise RuntimeError(
                f"gauge callbacks without a METRICS declaration: {sorted(gauge_sources)}"
            )
        stage_hist = m.get("stage_latency_seconds")
        for stage in STAGES:
            stage_hist.declare(stage=stage)

    def enable_tracing(self, ring: int = 256) -> None:
        """Turn on request-scoped span tracing.

        Every subsequent workload gets a span tree (validate → encode),
        attached to its response as ``timings`` and kept in a bounded ring
        of ``ring`` traces (:meth:`Tracer.last`, :meth:`Tracer.summary`).
        Tracing adds per-stage clock reads and a device synchronisation
        per span — leave it off for peak-throughput serving.
        """
        self.tracer.enable(ring=ring)

    def disable_tracing(self) -> None:
        """Back to zero-overhead mode (finished traces stay in the ring)."""
        self.tracer.disable()

    def _on_device(self, a) -> torch.Tensor:
        return _tensor(a, self.device)

    def _class_labels(self, y) -> torch.Tensor:
        """Integer class labels on the engine's device as int64, so int32
        and int64 callers share one launch signature (as warm-up's do)."""
        y = self._on_device(y)
        return y if y.is_floating_point() else y.to(torch.int64)

    # ------------------------------------------------------------------
    # Plans
    # ------------------------------------------------------------------

    def plan(
        self,
        x,
        folds,
        lam: float,
        mode: str = "auto",
        with_train_block: bool = True,
        version: int = 0,
    ):
        """Fetch-or-build the plan for (x, folds, λ). Returns (key, plan).

        Lookup order: memory (PlanCache) → disk (PlanStore, when
        configured) → build. A plan *with* the train block is a superset
        of the one without (same H, same factors, extra H_{Tr,Te}), so a
        ridge request is happily served from a cached bias-adjust plan.
        ``version`` is the dataset-registry version the key is minted
        under (0 for unregistered / freshly registered data). ``x`` and
        ``folds`` are moved to the engine's device; the key fingerprints
        ``x`` (a host copy of it)."""
        x, folds = self._on_device(x), as_folds(folds, self.device)
        with self.tracer.span("cache_lookup"):
            key = fastcv.plan_key(x, folds, lam, mode, with_train_block,
                                  version=version, precision=self.config.precision)
        return self._plan_at(key, x, folds, lam, mode, with_train_block)

    def _plan_at(self, key, x, folds, lam, mode, with_train_block: bool):
        """(key, plan) under an already-minted key (no fingerprint): the
        registry's path. ``key``'s last element is set to the flag."""
        key = key[:-1] + (bool(with_train_block),)
        with self.tracer.span("cache_lookup"):
            if not with_train_block:
                superset = key[:-1] + (True,)
                plan = self.cache.get(superset)
                if plan is not None:
                    return superset, plan
        plan, _ = self.cache.get_or_build(
            key,
            lambda: self._build_plan(x, folds, lam, mode, with_train_block, key=key),
            fetch=self._store_fetch(key),
        )
        return key, plan

    def _store_fetch(self, key):
        """Read-through closure for the disk tier (None when no store).

        ``store_load`` is its own trace stage: warm-boot budgets care
        whether a miss cost a disk read or an O(N²P) rebuild.
        """
        if self.store is None:
            return None

        def fetch():
            with self.tracer.span("store_load"):
                return self.tracer.sync(self.store.load(key))

        return fetch

    def _build_plan(self, x, folds, lam, mode, with_train_block, key=None):
        # Top-level span (not nested under cache_lookup) so the build cost
        # lands in its own stage_latency_seconds series.
        with self.tracer.span("plan_build"):
            n, p = x.shape
            resolved = ("dual" if p >= n else "primal") if mode == "auto" else mode
            gram = None
            if self.config.mesh is not None and resolved == "dual":
                gram = distributed.distributed_gram(x, self.config.mesh,
                                                    feature_axis=self.config.feature_axis)
            plan = self.tracer.sync(
                fastcv.prepare(
                    x, folds, lam, mode=resolved, with_train_block=with_train_block,
                    gram=gram, precision=self.config.precision
                )
            )
        with self._lock:
            self.plans_built += 1
        if key is not None and self.store is not None and self.config.save_plans:
            # Write-behind: snapshot now, commit off the request path. The
            # current pin set shields those entries from this write's GC.
            self.store.save_async(key, plan, protect=self.cache.pinned_keys())
        return plan

    def flush_store(self) -> None:
        """Join outstanding write-behind plan saves (shutdown path);
        no-op without a configured store."""
        if self.store is not None:
            self.store.flush()

    # ------------------------------------------------------------------
    # Dataset registry: register once, serve by handle
    # ------------------------------------------------------------------

    def register(self, x, folds, lam: float, mode: str = "auto") -> DatasetHandle:
        """Register a dataset; returns a :class:`DatasetHandle`.

        The handle is keyed by the same content fingerprint the plan cache
        uses (``fastcv.plan_key``), so registering identical bytes twice
        yields the same handle. The key is minted here, once: resolving the
        handle later reuses it. The engine keeps its own copies of ``x``
        and ``folds`` on its device, so a plan evicted under byte pressure
        rebuilds transparently on next use, from the bytes the key names
        even if the caller later changes its arrays in place (the reference
        fingerprinted X again on every resolve; one device copy here costs
        far less). Handle-scoped operations:
        :meth:`warmup` (accepts a handle), :meth:`pin`/:meth:`unpin` (via
        ``handle.key``), :meth:`evict`, and the :meth:`datasets`
        introspection view.

        With tracing on, a registration is a trace of its own
        (``kind="register"``) whose top-level span is ``fingerprint``: it
        lands in the ring and in ``stage_latency_seconds{stage="fingerprint"}``.
        """
        trace = self.tracer.trace(kind="register")
        with self.tracer.activate(trace):
            x, folds = self._on_device(x), as_folds(folds, self.device)
            key = fastcv.plan_key(x, folds, lam, mode, True, version=0,
                                  precision=self.config.precision)
            rec = self._datasets.get(key)
            if rec is None:
                handle = DatasetHandle(
                    key=key, n=int(x.shape[0]), p=int(x.shape[1]), lam=float(lam), mode=mode
                )
                owned = Folds(folds.te_idx.clone(), folds.tr_idx.clone(), folds.n)
                rec = self._datasets[key] = _DatasetRecord(handle, x.clone(), owned,
                                                           float(lam), mode)
        self.tracer.finish(trace)
        return rec.handle

    def dataset_record(self, handle: DatasetHandle) -> _DatasetRecord:
        rec = self._datasets.get(handle.key)
        if rec is None:
            raise KeyError(f"dataset handle {handle.key[0][:8]} is not registered on this engine")
        return rec

    def resolve(self, dataset, with_train_block: bool = True):
        """(key, plan) for a :class:`DatasetHandle` or inline spec.

        Handles resolve through the registry under the key minted at
        registration (rebuilding the plan if it was evicted, never hashing
        X again); anything with ``x`` / ``folds`` / ``lam`` attributes —
        e.g. :class:`repro_torch.serve.workload.DatasetSpec` — is planned
        directly (one fingerprint of X per call).
        """
        if isinstance(dataset, DatasetHandle):
            rec = self.dataset_record(dataset)
            with self._lock:
                rec.served += 1
            rec.last_used = time.time()
            return self._plan_at(rec.handle.key, rec.x, rec.folds, rec.lam, rec.mode,
                                 with_train_block)
        mode = getattr(dataset, "mode", "auto")
        return self.plan(
            dataset.x,
            dataset.folds,
            dataset.lam,
            mode=mode,
            with_train_block=with_train_block,
            version=getattr(dataset, "version", 0),
        )

    def evict(self, handle: DatasetHandle, *, deregister: bool = False) -> bool:
        """Drop a registered dataset's cached plans (both train-block
        variants); with ``deregister`` also forget the registration."""
        rec = self._datasets.get(handle.key)
        removed = self.cache.remove(handle.key)
        no_train = handle.key[:-1] + (False,)
        removed = self.cache.remove(no_train) or removed
        if deregister and rec is not None:
            del self._datasets[handle.key]
        return removed

    # ------------------------------------------------------------------
    # Mutable versioned datasets: append / retire / sliding window
    # ------------------------------------------------------------------

    def update_dataset(
        self,
        handle: DatasetHandle,
        *,
        x_new=None,
        drop_idx=None,
        folds_delta=None,
    ) -> DatasetHandle:
        """Advance a registered dataset to version n+1 and return its handle.

        Exactly one logical operation per call, picked by the arguments:
        ``x_new`` alone appends rows (round-robin over folds by default —
        requires ``len(x_new) % K == 0`` — or per ``folds_delta``),
        ``drop_idx`` alone retires rows, both together slide the window
        (appended rows inherit the dropped rows' fold slots unless
        ``folds_delta`` says otherwise). Dual-mode plans advance by the
        rank-k correction in :func:`repro_torch.core.fastcv.update_plan`
        (f64 on the engine's device) — no Gram rebuild; primal plans fall
        back to a from-scratch rebuild with the same fold evolution.
        ``x_new`` is moved to the engine's device.

        The previous version stays registered and servable (in-flight
        workloads pin it via :meth:`retain_version`) until
        :meth:`release` — the two versions have distinct plan keys, so the
        PlanCache/PlanStore never conflate them. The new version's key
        fingerprints the updated X once, here.
        """
        # reprolint: host-path
        rec = self.dataset_record(handle)
        if x_new is None and drop_idx is None:
            raise ValueError(
                "update_dataset needs x_new (append), drop_idx (retire), or both (window)"
            )
        n, p = int(rec.x.shape[0]), int(rec.x.shape[1])
        if x_new is not None:
            x_new = self._on_device(x_new)
        k = 0 if x_new is None else int(x_new.shape[0])
        drop = None
        if drop_idx is not None:
            drop = fastcv._host_ints(drop_idx).reshape(-1).astype(np.int64)
        d = 0 if drop is None else int(drop.size)
        if k and not d and folds_delta is None:
            n_folds = rec.folds.k
            if k % n_folds:
                raise ValueError(
                    f"appending {k} rows to a {n_folds}-fold dataset without "
                    "folds_delta would leave ragged folds; pass a per-row fold "
                    f"assignment or append a multiple of {n_folds} rows"
                )
            folds_delta = np.arange(k, dtype=np.int64) % n_folds
        op = "window" if (k and d) else ("append" if k else "retire")
        resolved = rec.mode
        if resolved == "auto":
            resolved = "dual" if p >= n else "primal"
        _, plan = self._plan_at(rec.handle.key, rec.x, rec.folds, rec.lam, rec.mode, True)
        with self.tracer.span("plan_update"):
            if resolved == "dual":
                if op == "window":
                    plan2 = fastcv.sliding_window(
                        plan,
                        x_new,
                        drop,
                        x=rec.x,
                        lam=rec.lam,
                        mode="dual",
                        folds_delta=folds_delta,
                    )
                elif op == "append":
                    plan2 = fastcv.update_plan(
                        plan, x_new, folds_delta, x=rec.x, lam=rec.lam, mode="dual"
                    )
                else:
                    plan2 = fastcv.downdate_plan(plan, drop, x=rec.x, lam=rec.lam, mode="dual")
                folds2 = Folds.with_indices(plan2.te_idx, plan2.tr_idx, n=n - d + k)
            else:
                folds2 = self._updated_folds(rec, k, drop, folds_delta)
                plan2 = None
            x2 = rec.x
            if d:
                keep = np.setdiff1d(np.arange(n), drop)
                x2 = x2[torch.from_numpy(keep).to(self.device)]
            if k:
                # X lives on the engine's device; a host round trip of (N, P) costs more
                x2 = torch.cat([x2, x_new.to(x2.dtype)])  # reprolint: ignore[RL001] -- X on device
            new_version = rec.version + 1
            new_key = fastcv.plan_key(x2, folds2, rec.lam, resolved, True,
                                      version=new_version,
                                      precision=self.config.precision)
            if plan2 is None:
                plan2 = self._build_plan(x2, folds2, rec.lam, resolved, True, key=new_key)
            else:
                self.cache.get_or_build(new_key, lambda: plan2)
                if self.store is not None and self.config.save_plans:
                    self.store.save_async(new_key, plan2, protect=self.cache.pinned_keys())
        new_handle = DatasetHandle(
            key=new_key,
            n=int(x2.shape[0]),
            p=p,
            lam=rec.lam,
            mode=resolved,
            version=new_version,
            n_appended=rec.n_appended + k,
        )
        rec2 = self._datasets.get(new_key)
        if rec2 is None:
            rec2 = self._datasets[new_key] = _DatasetRecord(
                new_handle,
                x2,
                folds2,
                rec.lam,
                resolved,
                version=new_version,
                n_appended=rec.n_appended + k,
            )
        with self._lock:
            self.plans_updated += 1
        self.metrics.inc("plan_updates_total", op=op)
        self.metrics.observe("plan_update_rank", float(k + d))
        return rec2.handle

    def _updated_folds(self, rec: _DatasetRecord, k: int, drop, folds_delta) -> Folds:
        """Fold evolution for the primal (full-rebuild) fallback — the same
        geometry the dual fast path derives from the corrected plan."""
        if isinstance(folds_delta, Folds):
            f = as_folds(folds_delta, self.device)
            return Folds(f.te_idx.clone(), f.tr_idx.clone(), f.n)
        te = fastcv._host_ints(rec.folds.te_idx).astype(np.int64)
        n = int(rec.x.shape[0])
        d = 0 if drop is None else int(drop.size)
        if k and d:
            if folds_delta is None:
                if k != d:
                    raise ValueError(
                        "sliding-window update without folds_delta requires "
                        "len(x_new) == len(drop_idx) so appended rows can "
                        f"inherit fold slots (got {k} new vs {d} dropped)"
                    )
                assign = fastcv._fold_of(te, np.sort(drop))
            else:
                assign = fastcv._host_ints(folds_delta).reshape(-1).astype(np.int64)
            te2 = fastcv._window_folds(te, n, drop, assign)
        elif k:
            assign = fastcv._host_ints(folds_delta).reshape(-1).astype(np.int64)
            te2 = fastcv._extend_folds(te, n, assign)
        else:
            te2 = fastcv._drop_folds(te, n, drop)
        tr2 = fastcv._complement_folds(te2, n - d + k)
        return Folds.with_indices(
            torch.from_numpy(te2.astype(np.int32)).to(self.device),
            torch.from_numpy(tr2.astype(np.int32)).to(self.device),
            n=n - d + k,
        )

    def append(self, handle: DatasetHandle, x_new, folds_delta=None) -> DatasetHandle:
        """Append rows to a registered dataset → version n+1 handle.

        Sugar for :meth:`update_dataset`; see it for fold-assignment rules
        and version-pinning semantics.
        """
        return self.update_dataset(handle, x_new=x_new, folds_delta=folds_delta)

    def retire(self, handle: DatasetHandle, idx) -> DatasetHandle:
        """Retire rows of a registered dataset → version n+1 handle."""
        return self.update_dataset(handle, drop_idx=idx)

    def release(self, handle: DatasetHandle, *, drop_store: bool = False) -> bool:
        """Release a dataset version: deregister it and drop its cached
        plans once no in-flight workload pins it.

        With refs outstanding the version is only marked ``retired`` and
        the purge happens on the last :meth:`release_version`. With
        ``drop_store`` the durable :class:`PlanStore` entry is removed too
        (a clean removal — stale versions are *not* quarantined); without
        it the store entry stays for forensic warm-boots. Returns True if
        the purge ran now, False if deferred (or unknown handle).
        """
        rec = self._datasets.get(handle.key)
        if rec is None:
            return False
        with self._lock:
            rec.retired = True
            rec.drop_store = drop_store
            if rec.refs > 0:
                return False
        self._purge(handle.key, drop_store)
        return True

    def retain_version(self, key) -> None:
        """Pin a dataset version for an in-flight workload batch.

        Tolerant no-op for keys that are not registered versions (inline
        specs, raw plan keys)."""
        rec = self._datasets.get(key)
        if rec is not None:
            with self._lock:  # batches on several threads pin one version
                rec.refs += 1

    def release_version(self, key) -> None:
        """Drop an in-flight pin; purges the version if it was released
        (retired) while pinned. Tolerant no-op on unknown keys."""
        rec = self._datasets.get(key)
        if rec is None:
            return
        with self._lock:
            rec.refs = max(0, rec.refs - 1)
            purge = rec.retired and rec.refs == 0
        if purge:
            self._purge(key, rec.drop_store)

    def _purge(self, key, drop_store: bool) -> None:
        """Forget a dataset version: registry entry, both cached plan
        variants, and (optionally) the durable store entry — cleanly, so
        eviction of a stale version never quarantines its checkpoint."""
        self._datasets.pop(key, None)
        self.cache.unpin(key)
        self.cache.remove(key)
        no_train = key[:-1] + (False,)
        self.cache.unpin(no_train)
        self.cache.remove(no_train)
        if drop_store and self.store is not None:
            self.store.remove(key)
            self.store.remove(no_train)

    def datasets(self) -> tuple:
        """Introspection view: one dict per registered dataset."""
        out = []
        for key, rec in self._datasets.items():
            plan = self.cache.peek(key) or self.cache.peek(key[:-1] + (False,))
            out.append(
                {
                    "handle": rec.handle,
                    "n": rec.handle.n,
                    "p": rec.handle.p,
                    "lam": rec.lam,
                    "mode": rec.mode,
                    "version": rec.version,
                    "n_appended": rec.n_appended,
                    "served": rec.served,
                    "resident": plan is not None,
                    "pinned": key in self.cache.pinned_keys(),
                    "nbytes": plan.nbytes if plan is not None else 0,
                }
            )
        return tuple(out)

    # -- pinning (PlanCache passthrough) -------------------------------

    def pin(self, key) -> bool:
        """Exempt a cached plan from eviction; see :meth:`PlanCache.pin`.

        Accepts a raw plan key or a :class:`DatasetHandle`.
        """
        return self.cache.pin(key.key if isinstance(key, DatasetHandle) else key)

    def unpin(self, key) -> bool:
        return self.cache.unpin(key.key if isinstance(key, DatasetHandle) else key)

    # ------------------------------------------------------------------
    # Warm-up: pre-build plans, serve every bucket of the eval family once
    # ------------------------------------------------------------------

    def warmup(
        self,
        spec,
        tasks: Sequence[str] = ("binary",),
        buckets: Optional[Sequence[int]] = None,
        *,
        num_classes: int = 0,
        metric: str = "accuracy",
        adjust_bias: bool = True,
        dissimilarity: str = "accuracy",
        comparison: str = "spearman",
        num_model_rdms: int = 0,
        pin: bool = False,
    ) -> dict:
        """Pre-build the plan for ``spec`` and serve the eval family once.

        ``spec`` is a :class:`DatasetHandle` or anything with ``x`` /
        ``folds`` / ``lam`` (and optionally ``mode``) attributes.
        ``tasks`` selects eval families from {"binary", "ridge",
        "multiclass", "permutation", "rsa"}; ``buckets`` the label-batch
        sizes to serve (default: every configured bucket; values are
        canonicalised via ``bucket_size``). After a warm-up covering the
        shapes traffic will hit, ``compile_count()`` stays flat and every
        kernel of those paths has been built and launched at those shapes.

        The "rsa" task serves the pairwise-contrast path for
        (``dissimilarity``, ``adjust_bias``); with ``num_model_rdms`` > 0
        it also serves the model-scoring + permutation-null paths for
        ``comparison`` at every null bucket (the model count M is part of
        the shape, so pass the M real traffic will carry).

        With ``pin=True`` the built plan is pinned in the cache (never
        LRU-evicted, excluded from budget pressure) until ``unpin``.
        Returns a summary dict (plan_key, buckets, compiles, pinned).
        """
        unknown = [t for t in tasks if t not in _WARMUP_TASKS]
        if unknown:
            raise ValueError(f"unknown warmup tasks {unknown}; expected {_WARMUP_TASKS}")
        if "multiclass" in tasks and num_classes < 2:
            raise ValueError("warmup of 'multiclass' needs num_classes >= 2")
        if isinstance(spec, DatasetHandle):  # the registry's key; not counted as served
            rec = self.dataset_record(spec)
            key, plan = self._plan_at(rec.handle.key, rec.x, rec.folds, rec.lam, rec.mode, True)
        else:
            key, plan = self.resolve(spec, with_train_block=True)
        wanted = sorted(
            {bucket_size(b, self.config.buckets) for b in (buckets or self.config.buckets)}
        )
        n = int(plan.h.shape[0])
        dev = self.device
        y_bin = torch.where(torch.arange(n, device=dev) % 2 == 0, -1.0, 1.0).to(plan.h.dtype)
        y_mc = torch.arange(n, dtype=torch.int64, device=dev) % max(num_classes, 2)
        if "permutation" in tasks:
            self.observed_binary(plan, y_bin, metric=metric, adjust_bias=adjust_bias)
            if num_classes >= 2:
                self.observed_multiclass(plan, y_mc, num_classes=num_classes)
        for b in wanted:
            cols = y_bin[:, None].repeat(1, b)
            if "binary" in tasks:
                self.eval_binary(plan, cols, adjust_bias)
            if "ridge" in tasks:
                self.eval_ridge(plan, cols)
            if "multiclass" in tasks:
                self.eval_multiclass(plan, y_mc[None, :].repeat(b, 1), num_classes)
            if "permutation" in tasks:
                perms = perm_lib.permutation_indices(0, n, b, device=dev)
                self.null_binary(plan, y_bin, perms, metric=metric, adjust_bias=adjust_bias)
                if num_classes >= 2:  # mirrors the observed_multiclass gate above
                    self.null_multiclass(plan, y_mc, perms, num_classes=num_classes)
            if "rsa" in tasks:
                self.eval_rsa_pairs(plan, cols, dissimilarity, adjust_bias)
        if "rsa" in tasks and num_model_rdms > 0:
            if num_classes < 2:
                raise ValueError("rsa model-scoring warmup needs num_classes >= 2")
            rdm0 = torch.zeros((num_classes, num_classes), dtype=plan.h.dtype, device=dev)
            models0 = torch.zeros((num_model_rdms,) + tuple(rdm0.shape), dtype=plan.h.dtype,
                                  device=dev)
            self.score_rdms(rdm0, models0, comparison)
            for b in wanted:
                perms0 = perm_lib.permutation_indices(0, num_classes, b, device=dev)
                self.null_rdm_scores(rdm0, models0, perms0, comparison)
        _synchronize(dev)
        pinned = self.cache.pin(key) if pin else False
        return {
            "plan_key": key,
            "buckets": tuple(wanted),
            "compiles": self.compile_count(),
            "pinned": pinned,
        }

    # ------------------------------------------------------------------
    # Shape-bucketed evaluation
    # ------------------------------------------------------------------

    @staticmethod
    def _strip_train(plan: fastcv.CVPlan) -> fastcv.CVPlan:
        """Canonicalise a plan for train-block-free eval paths.

        A no-train-block request may be served from the cached *superset*
        plan (see :meth:`plan`), whose ``h_tr_te`` is a tensor instead of
        None. Stripping the block keeps one signature per shape and sends
        the eval down the fused ``fold_eval`` route, which skips the unused
        Eq. 15 train solves.
        """
        if plan.h_tr_te is None:
            return plan
        return dataclasses.replace(plan, h_tr_te=None)

    def _evaluator(self, family: str, key, make) -> _Evaluator:
        """The evaluator of ``family`` (the name of one of the evaluator
        tables) under ``key``, made on first use."""
        table = getattr(self, family)
        fn = table.get(key)
        if fn is None:
            fn = table[key] = _Evaluator(make(), f"{family.lstrip('_')}{key!r}", self)
        return fn

    # The reference copied an exact-bucket batch the engine did not create
    # before a donating eval could invalidate it (its ``owned`` flag). Eager
    # PyTorch never aliases an input into an output: no copy is needed.

    def _pad_cols(self, y: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(N, B) → row-major (N, bucket) with zero columns, and B."""
        b = y.shape[1]
        padded = bucket_size(b, self.config.buckets)
        if padded > b:
            y = torch.cat([y, y.new_zeros((y.shape[0], padded - b))], dim=1)
        return y.contiguous(), b

    def _pad_rows(self, y: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(B, ...) → (bucket, ...) repeating the first row, and B."""
        b = y.shape[0]
        padded = bucket_size(b, self.config.buckets)
        if padded > b:
            y = torch.cat([y, y[:1].expand((padded - b,) + tuple(y.shape[1:]))], dim=0)
        return y.contiguous(), b

    def eval_estimator(self, plan: fastcv.CVPlan, y, estimator: str, **opts):
        """Shape-bucketed eval through the least-squares estimator registry.

        ``estimator`` names a registered
        :class:`~repro_torch.serve.workload.LeastSquaresSpec`; the spec
        supplies the targets encoding, batch layout, evaluator factory,
        and train-block requirement — this one method is the engine's
        entire CV eval surface, so a newly registered estimator is served,
        bucketed, and signature-counted with zero engine changes. ``y`` is
        moved to the engine's device.
        """
        spec = get_estimator(estimator)
        opts = spec.resolve_opts(opts)
        if not spec.needs_train(opts):
            plan = self._strip_train(plan)
        batch, squeeze = spec.encode(self._on_device(y), plan.h.dtype, opts)
        key = (spec.eval_key, spec.static_key(opts))
        fn = self._evaluator("_evals", key, lambda: spec.make_eval(opts, self._fused))
        if spec.layout == "columns":
            padded, b = self._pad_cols(batch)
            with self.tracer.span("eval"):
                out = self.tracer.sync(fn(plan, padded)[..., :b])
            with self._lock:
                self.labels_evaluated += b
            return out[..., 0] if squeeze else out
        padded, b = self._pad_rows(batch)
        with self.tracer.span("eval"):
            out = self.tracer.sync(fn(plan, padded)[:b])
        with self._lock:
            self.labels_evaluated += b
        return out[0] if squeeze else out

    def eval_binary(self, plan: fastcv.CVPlan, y, adjust_bias: bool = True) -> torch.Tensor:
        """Binary-LDA decision values. y: (N,) or (N, B) ±1 labels."""
        return self.eval_estimator(plan, y, "binary", adjust_bias=adjust_bias)

    def eval_ridge(self, plan: fastcv.CVPlan, y) -> torch.Tensor:
        """Exact CV ridge predictions ẏ_Te. y: (N,) or (N, B) responses."""
        return self.eval_estimator(plan, y, "ridge")

    def eval_multiclass(
        self, plan: fastcv.CVPlan, y, num_classes: int
    ) -> torch.Tensor:
        """Multi-class LDA CV predictions. y: int (N,) or (B, N)."""
        return self.eval_estimator(plan, y, "multiclass", num_classes=num_classes)

    # ------------------------------------------------------------------
    # RSA serving (pairwise-contrast RDMs + model scoring, §4.2)
    # ------------------------------------------------------------------

    def eval_rsa_pairs(
        self,
        plan: fastcv.CVPlan,
        cols,
        dissimilarity: str = "accuracy",
        adjust_bias: bool = True,
    ) -> torch.Tensor:
        """Pairwise-contrast dissimilarities. cols: (N, B) ±1/0 columns.

        Contrast columns are just label columns, so they ride the same
        bucketed column path as binary/ridge evals: padded (all-zero)
        columns score to a harmless constant and are sliced away.
        """
        cache_key = (dissimilarity, adjust_bias)
        fn = self._evaluator("_rsa_pairs", cache_key, lambda: rsa_rdm.make_eval_pairs(
            dissimilarity, adjust_bias, fused=self._fused))
        if not adjust_bias:
            plan = self._strip_train(plan)
        cols = self._on_device(cols).to(plan.h.dtype)
        padded, b = self._pad_cols(cols)
        with self.tracer.span("eval"):
            out = self.tracer.sync(fn(plan, padded)[:b])
        with self._lock:
            self.labels_evaluated += b
        return out

    def score_rdms(self, empirical, model_rdms, method: str = "spearman") -> torch.Tensor:
        """(M,) model-RDM scores."""
        fn = self._evaluator("_rsa_score", method, lambda: rsa_compare.make_compare(method))
        with self.tracer.span("eval"):
            return self.tracer.sync(fn(self._on_device(empirical),
                                       self._on_device(model_rdms)))

    def null_rdm_scores(self, empirical, model_rdms, perms, method: str = "spearman"
                        ) -> torch.Tensor:
        """(M, B) null scores for explicit condition permutations (B, C).

        The permutation batch pads up to a shape bucket like every other
        batched path, so chunked (streaming) nulls serve one shape per
        chunk bucket.
        """
        with self.tracer.span("null_chunk"):
            fn = self._evaluator("_rsa_null", method,
                                 lambda: rsa_compare.make_compare_null(method))
            padded, b = self._pad_rows(self._on_device(perms))
            return self.tracer.sync(fn(self._on_device(empirical),
                                       self._on_device(model_rdms), padded)[:, :b])

    def compare_rdms(
        self,
        empirical,
        model_rdms,
        method: str = "spearman",
        n_perm: int = 0,
        seed: int = 0,
    ):
        """Score model RDMs against an empirical RDM; optional null.

        Returns (scores (M,), null (M, n_perm) | None, p (M,) | None).
        Null permutations are drawn from ``seed`` at the bucketed size
        (prefix-stable, like the CV permutation path), so arbitrary
        client-chosen n_perm serve one shape per bucket.
        """
        scores = self.score_rdms(empirical, model_rdms, method)
        if n_perm <= 0:
            return scores, None, None
        t_gen = bucket_size(n_perm, self.config.buckets)
        # Draw generation and the p-value are null-distribution work: they
        # count toward the null_chunk stage like the CV permutation path.
        with self.tracer.span("null_chunk"):
            perms = self.tracer.sync(
                perm_lib.permutation_indices(seed, empirical.shape[0], t_gen,
                                             device=self.device)
            )
        null = self.null_rdm_scores(empirical, model_rdms, perms, method)
        with self.tracer.span("null_chunk"):
            null = null[:, :n_perm]
            p = self.tracer.sync(_rdm_p_value(scores, null))
        return scores, null, p

    # ------------------------------------------------------------------
    # Permutation serving (Algorithms 1 & 2 against a cached plan)
    # ------------------------------------------------------------------

    def _perm_binary_fn(self, metric: str, adjust_bias: bool) -> _Evaluator:
        """(plan, y (N,), perms (B, N)) -> (B,) metrics.

        The permuted labels are gathered into one row-major (N, B) block,
        the layout the kernels take: on CUDA the whole bucket is one
        hat_apply and one foldsolve launch (or one fold_eval)."""
        fused = self._fused

        def make():
            def _eval(plan, y, perms):
                yp = y[perms].T.contiguous()  # (N, B)
                dv = fastcv.binary_dvals(plan, yp, adjust_bias=adjust_bias, fused=fused)
                return perm_lib._fold_metric_binary(dv, yp[plan.te_idx], metric)

            return _eval

        return self._evaluator("_perm_binary", (metric, adjust_bias), make)

    def _perm_multiclass_fn(self, num_classes: int) -> _Evaluator:
        """(plan, y (N,), perms (B, N)) -> (B,) accuracies; the B·C
        indicator columns are one block through the eval route."""
        fused = self._fused

        def make():
            def _eval(plan, y, perms):
                y_rows = y[perms]  # (B, N)
                preds = multiclass.batch_predict(plan, y_rows, num_classes, fused=fused)
                hits = preds == y_rows[:, plan.te_idx]  # (B, K, m)
                return metrics.share(hits.sum(dim=(1, 2)), hits.shape[1] * hits.shape[2])

            return _eval

        return self._evaluator("_perm_multiclass", num_classes, make)

    def _identity(self, n: int) -> torch.Tensor:
        """The (1, N) identity permutation, padded to its bucket."""
        identity = torch.arange(n, dtype=torch.int64, device=self.device)[None]
        return self._pad_rows(identity)[0]

    def observed_binary(
        self,
        plan: fastcv.CVPlan,
        y,
        *,
        metric: str = "accuracy",
        adjust_bias: bool = True,
    ) -> torch.Tensor:
        """Observed (unpermuted) binary metric through the permutation path."""
        # The span covers the dispatch preamble (dtype cast, identity
        # batch, padding) too.
        with self.tracer.span("eval"):
            if not adjust_bias:
                plan = self._strip_train(plan)
            y = self._on_device(y).to(plan.h.dtype)
            fn = self._perm_binary_fn(metric, adjust_bias)
            return self.tracer.sync(fn(plan, y, self._identity(y.shape[0]))[0])

    def null_binary(
        self,
        plan: fastcv.CVPlan,
        y,
        perms,
        *,
        metric: str = "accuracy",
        adjust_bias: bool = True,
    ) -> torch.Tensor:
        """Null metrics for an explicit (B, N) permutation batch → (B,).

        The chunk-level building block under both :meth:`permutation_binary`
        and ``workload.stream_workload``. On a mesh engine the batch shards
        over ``perm_axes`` through ``core.distributed.sharded_null_from_plan``
        (padded with edge rows to a whole number of shards, trimmed back), so
        streamed chunks take the mesh as monolithic requests do, with the
        same draws. Locally the batch pads up to a shape bucket, so repeats
        serve no new shape.
        """
        b = perms.shape[0]
        mesh = self.config.mesh
        with self.tracer.span("null_chunk"):
            if not adjust_bias:
                plan = self._strip_train(plan)
            y = self._on_device(y).to(plan.h.dtype)
            perms = self._on_device(perms)
            if mesh is not None:
                shards = 1
                for a in self.config.perm_axes:
                    shards *= mesh.shape[mesh.mesh_dim_names.index(a)]
                t_pad = -(-b // shards) * shards
                if t_pad > b:
                    perms = torch.cat([perms, perms[-1:].expand(t_pad - b, -1)])
                out = distributed.sharded_null_from_plan(
                    plan, y, perms, mesh, metric=metric, perm_axes=self.config.perm_axes,
                    adjust_bias=adjust_bias)[:b]
            else:
                fn = self._perm_binary_fn(metric, adjust_bias)
                out = fn(plan, y, self._pad_rows(perms)[0])[:b]
            out = self.tracer.sync(out)
        with self._lock:
            self.labels_evaluated += b
        return out

    def observed_multiclass(self, plan: fastcv.CVPlan, y, *, num_classes: int) -> torch.Tensor:
        with self.tracer.span("eval"):
            y = self._class_labels(y)
            fn = self._perm_multiclass_fn(num_classes)
            return self.tracer.sync(fn(plan, y, self._identity(y.shape[0]))[0])

    def null_multiclass(self, plan: fastcv.CVPlan, y, perms, *, num_classes: int
                        ) -> torch.Tensor:
        """Multi-class analogue of :meth:`null_binary` → (B,) accuracies."""
        with self.tracer.span("null_chunk"):
            fn = self._perm_multiclass_fn(num_classes)
            padded, b = self._pad_rows(self._on_device(perms))
            out = self.tracer.sync(fn(plan, self._class_labels(y), padded)[:b])
        with self._lock:
            self.labels_evaluated += b
        return out

    def permutation_binary(
        self,
        plan: fastcv.CVPlan,
        y,
        n_perm: int,
        seed: int,
        *,
        metric: str = "accuracy",
        adjust_bias: bool = True,
    ) -> perm_lib.PermutationResult:
        """Algorithm 1 against a cached plan: observed + null + p-value.

        The T = ``n_perm`` draws are generated from ``seed`` at the bucket
        of T (prefix-stable: the first T rows are the draws of
        ``core.permutation`` with that seed) and evaluated as one padded
        batch: on CUDA one launch of each eval kernel for the whole null.
        """
        y = self._on_device(y)
        n = y.shape[0]
        observed = self.observed_binary(plan, y, metric=metric, adjust_bias=adjust_bias)
        # Draw generation and the p-value are null-distribution work, so
        # they count toward the null_chunk stage (timings() sums same-name
        # top-level spans).
        t_gen = bucket_size(n_perm, self.config.buckets)
        with self.tracer.span("null_chunk"):
            perms = self.tracer.sync(perm_lib.permutation_indices(seed, n, t_gen,
                                                                  device=self.device))
        null = self.null_binary(plan, y, perms, metric=metric, adjust_bias=adjust_bias)[:n_perm]
        # null_binary counted the bucketed batch; this API's contract (and
        # the multiclass path) counts the *requested* draws only.
        with self._lock:
            self.labels_evaluated -= t_gen - n_perm
        with self.tracer.span("null_chunk"):
            p = self.tracer.sync(perm_lib.p_value(observed, null))
        return perm_lib.PermutationResult(observed, null, p)

    def permutation_multiclass(
        self,
        plan: fastcv.CVPlan,
        y,
        n_perm: int,
        seed: int,
        *,
        num_classes: int,
    ) -> perm_lib.PermutationResult:
        """Algorithm 2 under permutations against a cached plan."""
        fn = self._perm_multiclass_fn(num_classes)
        y = self._class_labels(y)
        n = y.shape[0]
        observed = self.observed_multiclass(plan, y, num_classes=num_classes)
        t_gen = bucket_size(n_perm, self.config.buckets)
        with self.tracer.span("null_chunk"):
            perms = self.tracer.sync(perm_lib.permutation_indices(seed, n, t_gen,
                                                                  device=self.device))
            null = self.tracer.sync(fn(plan, y, self._pad_rows(perms)[0])[:n_perm])
        with self._lock:
            self.labels_evaluated += n_perm
        with self.tracer.span("null_chunk"):
            p = self.tracer.sync(perm_lib.p_value(observed, null))
        return perm_lib.PermutationResult(observed, null, p)

    # ------------------------------------------------------------------
    # Tuning (routed to the eigendecomposition-based LOO machinery)
    # ------------------------------------------------------------------

    def tune(self, x, y, lambdas=None, criterion: str = "mse"):
        with self.tracer.span("eval"):
            # RidgeTuneResult is a NamedTuple of tensors — sync whole.
            return self.tracer.sync(tuning.tune_ridge(
                self._on_device(x), self._on_device(y), lambdas=lambdas, criterion=criterion))

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def compile_count(self) -> int:
        """Distinct input signatures served across every eval path.

        The eager counterpart of the reference's jit cache entries: each
        is a distinct launch shape of the eval route. Stable across
        requests == no new launch shape."""
        tables = (self._evals, self._perm_binary, self._perm_multiclass,
                  self._rsa_pairs, self._rsa_score, self._rsa_null)
        return int(sum(len(fn.signatures) for table in tables for fn in table.values()))

    def dataset_stats(self) -> dict:
        """JSON-safe per-registered-dataset breakdown.

        Keyed by the first 12 hex chars of the content fingerprint.
        ``plan_bytes`` counts the resident plan (either train-block
        variant), 0 when evicted; ``last_used`` is a wall-clock timestamp
        (0.0 = never served by handle). This is the handle-scoped view
        behind ``stats()["per_dataset"]``.
        """
        out = {}
        for key, rec in self._datasets.items():
            plan = self.cache.peek(key) or self.cache.peek(key[:-1] + (False,))
            out[str(key[0])[:12]] = {
                "n": rec.handle.n,
                "p": rec.handle.p,
                "version": rec.version,
                "n_appended": rec.n_appended,
                "served": rec.served,
                "plan_bytes": plan.nbytes if plan is not None else 0,
                "resident": plan is not None,
                "pinned": key in self.cache.pinned_keys(),
                "last_used": rec.last_used,
            }
        return out

    def stats(self) -> dict:
        """Flat engine/cache counters plus a ``per_dataset`` breakdown.

        The reference's keys (cache stats, plans_built, plans_updated,
        labels_evaluated, compiles, datasets_registered, rdm_hits,
        rdm_entries, store_*) — the metrics registry reads *these*
        counters through callback gauges, never the other way round. The
        ``store_*`` keys are always present (zero without a configured
        plan store). ``per_dataset`` is :meth:`dataset_stats`.
        """
        s = self.cache.stats.as_dict()
        st = self.store.stats if self.store is not None else None
        s.update(
            plans_built=self.plans_built,
            plans_updated=self.plans_updated,
            labels_evaluated=self.labels_evaluated,
            compiles=self.compile_count(),
            datasets_registered=len(self._datasets),
            rdm_hits=self.rdm_cache.hits,
            rdm_entries=len(self.rdm_cache),
            store_hits=st.hits if st else 0,
            store_misses=st.misses if st else 0,
            store_writes=st.writes if st else 0,
            store_bytes=st.bytes_in_store if st else 0,
        )
        s["per_dataset"] = self.dataset_stats()
        return s
