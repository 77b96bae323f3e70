"""repro_torch.serve.obs — zero-dependency metrics registry with Prometheus exposition.

The *metrics* half of the serving stack's observability layer: a small,
thread-safe registry of counters, gauges and fixed-bucket histograms that
the engine and batcher populate, rendered on demand as Prometheus text
exposition format 0.0.4 — no third-party client library involved. The
*tracing* half (per-request span trees) lives in
:mod:`repro_torch.serve.trace` and feeds its per-stage durations into this
registry's ``stage_latency_seconds`` histogram.

The module is a copy of the reference package's ``serve/obs.py`` (it
imports nothing but the standard library). :data:`METRICS` and
:data:`BUCKET_FAMILIES` equal the reference's entry for entry: reprolint's
RL003 checks every metric call site in ``src/`` against the reference's
table, and the two packages expose the same names. ``compile_events``
keeps its name; in this package it counts the distinct input signatures
the engine's eager evaluators have served (see
:meth:`repro_torch.serve.engine.CVEngine.compile_count`).

Design notes
------------
* **Counters** only go up (``inc``); **gauges** are either set directly
  (``set``) or — the common case here — registered with a zero-arg
  callback so existing sources of truth (``cache.stats.hits``,
  ``engine.compile_count()``) stay canonical and the registry is a pure
  *view*: ``engine.stats()`` keeps its schema bit-for-bit.
* **Histograms** use fixed bucket boundaries chosen at registration
  (:data:`LATENCY_BUCKETS_S` for stage latencies, :data:`SIZE_BUCKETS`
  for occupancy/coalesced-size distributions). Buckets are cumulative in
  the exposition (``le`` semantics) but stored as per-bucket counts.
* **Label cardinality cap** — every labelled metric folds label-sets
  beyond ``max_series_per_metric`` into a single ``_other`` overflow
  series (and counts the fold in ``registry.dropped_series``) so a
  misbehaving client cannot grow the registry without bound.
* **Thread safety** — one ``RLock`` around every mutation and render;
  the hot-path cost of ``inc``/``observe`` is one lock + dict update,
  cheap enough to leave permanently on (tracing, by contrast, is opt-in).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

__all__ = [
    "LATENCY_BUCKETS_S",
    "SIZE_BUCKETS",
    "BUCKET_FAMILIES",
    "METRICS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

# Stage latencies span ~100 microseconds (a warm bucketed eval) to ~10 s
# (a cold O(N^2 P) plan build); 16 roughly-logarithmic edges cover it.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4,
    2.5e-4,
    5e-4,
    1e-3,
    2.5e-3,
    5e-3,
    1e-2,
    2.5e-2,
    5e-2,
    1e-1,
    2.5e-1,
    5e-1,
    1.0,
    2.5,
    5.0,
    10.0,
)

# Occupancy / coalesced-size distributions: powers of two up to the
# largest label-batch shape bucket (DEFAULT_BUCKETS tops out at 1024).
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_OTHER = "_other"

# Bucket families referenced *by name* from METRICS, so the declaration
# table below stays a pure literal that reprolint can read via
# ast.literal_eval without importing this module.
BUCKET_FAMILIES = {"latency": LATENCY_BUCKETS_S, "size": SIZE_BUCKETS}

#: Central metric declarations — THE single source of truth for every
#: metric name, kind and label-key set in the serving stack. The engine
#: registers exactly this table (`CVEngine._declare_metrics`), reprolint
#: rule RL003 checks every literal call site against it, and gauge
#: callbacks are supplied by the engine at registration time. Keep it a
#: pure literal: reprolint AST-extracts it via `ast.literal_eval`.
METRICS = {
    "requests_total": {
        "kind": "counter",
        "labels": ("kind", "estimator"),
        "help": "Workloads served, by kind and estimator",
    },
    "plan_updates_total": {
        "kind": "counter",
        "labels": ("op",),
        "help": "Incremental dataset updates applied, by operation",
    },
    "stage_latency_seconds": {
        "kind": "histogram",
        "labels": ("stage",),
        "buckets": "latency",
        "help": "Per-stage request latency (traced requests only)",
    },
    "gather_window_occupancy": {
        "kind": "histogram",
        "labels": (),
        "buckets": "size",
        "help": "Requests coalesced per server gather window",
    },
    "batch_coalesced_size": {
        "kind": "histogram",
        "labels": (),
        "buckets": "size",
        "help": "Unpadded label-batch width per coalesced eval",
    },
    "plan_update_rank": {
        "kind": "histogram",
        "labels": (),
        "buckets": "size",
        "help": "Correction rank (rows appended + retired) per incremental update",
    },
    "plan_cache_hits": {"kind": "gauge", "labels": (), "help": "Plan cache hits"},
    "plan_cache_misses": {"kind": "gauge", "labels": (), "help": "Plan cache misses (builds)"},
    "plan_cache_evictions": {"kind": "gauge", "labels": (), "help": "Plan cache evictions"},
    "plan_cache_oversized": {
        "kind": "gauge",
        "labels": (),
        "help": "Builds served un-cached (over byte budget)",
    },
    "plan_cache_bytes_in_use": {
        "kind": "gauge",
        "labels": (),
        "help": "Plan cache resident bytes",
    },
    "plan_store_hits": {
        "kind": "gauge",
        "labels": (),
        "help": "Plans loaded (verified) from the disk store",
    },
    "plan_store_misses": {
        "kind": "gauge",
        "labels": (),
        "help": "Disk-store probes that found nothing usable",
    },
    "plan_store_writes": {
        "kind": "gauge",
        "labels": (),
        "help": "Plans committed to the disk store",
    },
    "plan_store_bytes": {
        "kind": "gauge",
        "labels": (),
        "help": "Committed plan-store bytes on disk",
    },
    "compile_events": {
        "kind": "gauge",
        "labels": (),
        "help": "jit cache entries across every eval path",
    },
    "rdm_hits": {"kind": "gauge", "labels": (), "help": "Empirical-RDM memo hits"},
    "plans_built": {"kind": "gauge", "labels": (), "help": "CVPlans built by this engine"},
    "plans_updated": {
        "kind": "gauge",
        "labels": (),
        "help": "CVPlans advanced by incremental rank-k correction",
    },
    "labels_evaluated": {"kind": "gauge", "labels": (), "help": "Label vectors evaluated"},
    "datasets_registered": {
        "kind": "gauge",
        "labels": (),
        "help": "Registered dataset handles",
    },
}


def _label_values(label_names: Tuple[str, ...], labels: dict) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(f"expected labels {label_names}, got {tuple(sorted(labels))}")
    return tuple(str(labels[k]) for k in label_names)


def _fmt_value(v: float) -> str:
    # Prometheus text format: render integral values without the trailing
    # ".0" so `compile_events 0` greps cleanly in CI.
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(label_names: Tuple[str, ...], values: Tuple[str, ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in zip(label_names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    """Shared labelled-series bookkeeping (cardinality cap included)."""

    kind = "untyped"

    def __init__(
        self, registry: "MetricsRegistry", name: str, help: str, label_names: Sequence[str]
    ):
        self.registry = registry
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _series_key(self, labels: dict) -> Tuple[str, ...]:
        key = _label_values(self.label_names, labels)
        if key not in self._series and len(self._series) >= self.registry.max_series_per_metric:
            self.registry.dropped_series += 1
            key = (_OTHER,) * len(self.label_names)
        return key


class Counter(_Metric):
    """Monotonically increasing count, optionally labelled."""

    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        with self.registry._lock:
            key = self._series_key(labels)
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        with self.registry._lock:
            return self._series.get(_label_values(self.label_names, labels), 0)

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, v in self._series.items():
            lines.append(f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(v)}")
        if not self._series:
            lines.append(f"{self.name} 0")
        return lines

    def as_dict(self) -> dict:
        if not self.label_names:
            return {"value": self._series.get((), 0)}
        return {",".join(k): v for k, v in self._series.items()}


class Gauge(_Metric):
    """Point-in-time value: set directly or backed by a zero-arg callback.

    Callback gauges (``fn=``) are evaluated lazily at render/read time so
    existing counters (cache stats, evaluator signatures) stay the single
    source of truth — the registry never shadows them with a stale copy.
    """

    kind = "gauge"

    def __init__(
        self, registry, name, help, label_names=(), fn: Optional[Callable[[], float]] = None
    ):
        super().__init__(registry, name, help, label_names)
        if fn is not None and self.label_names:
            raise ValueError("callback gauges cannot be labelled")
        self.fn = fn

    def set(self, value: float, **labels) -> None:
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        with self.registry._lock:
            self._series[self._series_key(labels)] = value

    def value(self, **labels) -> float:
        if self.fn is not None:
            return self.fn()
        with self.registry._lock:
            return self._series.get(_label_values(self.label_names, labels), 0)

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        if self.fn is not None:
            lines.append(f"{self.name} {_fmt_value(self.fn())}")
            return lines
        for key, v in self._series.items():
            lines.append(f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(v)}")
        if not self._series:
            lines.append(f"{self.name} 0")
        return lines

    def as_dict(self) -> dict:
        if self.fn is not None:
            return {"value": self.fn()}
        if not self.label_names:
            return {"value": self._series.get((), 0)}
        return {",".join(k): v for k, v in self._series.items()}


class _HistSeries:
    __slots__ = ("counts", "total", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram with Prometheus cumulative-``le`` exposition."""

    kind = "histogram"

    def __init__(self, registry, name, help, buckets: Sequence[float], label_names=()):
        super().__init__(registry, name, help, label_names)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        self.buckets = tuple(float(b) for b in buckets)

    def declare(self, **labels) -> None:
        """Pre-create a zero series so the exposition lists every declared
        label-set (e.g. all stage names) before any traffic arrives."""
        with self.registry._lock:
            key = self._series_key(labels)
            if key not in self._series:
                self._series[key] = _HistSeries(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        with self.registry._lock:
            key = self._series_key(labels)
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets))
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    series.counts[i] += 1
                    break
            series.total += value
            series.count += 1

    def snapshot(self, **labels) -> dict:
        """``{count, sum, buckets}`` for one series (zeros when absent)."""
        with self.registry._lock:
            series = self._series.get(_label_values(self.label_names, labels))
            if series is None:
                return {"count": 0, "sum": 0.0, "buckets": [0] * len(self.buckets)}
            return {
                "count": series.count,
                "sum": series.total,
                "buckets": list(series.counts),
            }

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key, series in self._series.items():
            cum = 0
            for edge, n in zip(self.buckets, series.counts):
                cum += n
                le = f'le="{_fmt_value(edge)}"'
                lines.append(f"{self.name}_bucket{_fmt_labels(self.label_names, key, le)} {cum}")
            labels = _fmt_labels(self.label_names, key)
            inf = _fmt_labels(self.label_names, key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{inf} {series.count}")
            lines.append(f"{self.name}_sum{labels} {_fmt_value(series.total)}")
            lines.append(f"{self.name}_count{labels} {series.count}")
        return lines

    def as_dict(self) -> dict:
        out = {}
        for key in self._series:
            out[",".join(key) if key else "value"] = self.snapshot(
                **dict(zip(self.label_names, key))
            )
        return out


class MetricsRegistry:
    """Insertion-ordered registry of counters/gauges/histograms.

    Registration is idempotent — re-registering an existing name returns
    the existing metric (so the engine can declare unconditionally) but a
    *type* mismatch raises. Convenience ``inc``/``observe``/``set_gauge``
    dispatch by name and raise ``KeyError`` on unknown metrics: silently
    dropping an instrumentation point would defeat the purpose.
    """

    # Concurrency contract, machine-checked by reprolint RL004.
    # (`dropped_series` is also lock-guarded, but it is incremented from
    # _Metric._series_key under the *caller's* lock acquisition, which a
    # lexical per-class checker cannot see — the per-metric mutators all
    # take `self.registry._lock` before touching series state.)
    _GUARDED_BY = {"_metrics": "_lock"}

    def __init__(self, max_series_per_metric: int = 64):
        self._lock = threading.RLock()
        self._metrics: "Dict[str, _Metric]" = {}
        self.max_series_per_metric = max_series_per_metric
        self.dropped_series = 0

    def _register(self, cls, name, help, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}"
                    )
                return existing
            metric = cls(self, name, help, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, label_names=labels)

    def gauge(
        self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None
    ) -> Gauge:
        return self._register(Gauge, name, help, fn=fn)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
        labels: Sequence[str] = (),
    ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets, label_names=labels)

    def get(self, name: str) -> _Metric:
        with self._lock:
            return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    # -- by-name conveniences (hot-path instrumentation calls) -------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        metric = self.get(name)
        if not isinstance(metric, Counter):
            raise TypeError(f"metric {name!r} is a {metric.kind}, not a counter")
        metric.inc(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        metric = self.get(name)
        if not isinstance(metric, Histogram):
            raise TypeError(f"metric {name!r} is a {metric.kind}, not a histogram")
        metric.observe(value, **labels)

    # -- exposition --------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 (trailing newline)."""
        with self._lock:
            lines = []
            for metric in self._metrics.values():
                lines.extend(metric.render())
            if self.dropped_series:
                lines.append(
                    "# HELP obs_dropped_series "
                    "Label-sets folded into _other by the cardinality cap"
                )
                lines.append("# TYPE obs_dropped_series counter")
                lines.append(f"obs_dropped_series {self.dropped_series}")
            return "\n".join(lines) + "\n"

    def as_dict(self) -> dict:
        with self._lock:
            return {name: m.as_dict() for name, m in self._metrics.items()}
