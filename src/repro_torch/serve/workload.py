"""One workload API: registered datasets, Workload specs, estimator registry.

The paper's central claim (Treder 2018, §2) is that the analytical-CV
identity holds for *every* ridge-regularised least-squares model. This
module makes the public surface say the same thing: instead of one request
class and one engine code path per model, there is

  * a **least-squares estimator registry** — :class:`LeastSquaresSpec`
    describes a model family by its targets encoding, batch layout,
    evaluator factory, and metric family. Binary LDA, multi-class LDA,
    ridge regression, and multi-target ridge are *registrations*, not
    engine forks; adding e.g. optimal-scoring LDA is one
    :func:`register_estimator` call away.
  * a **unified, versioned** :class:`Workload` spec — one dataclass schema
    (``kind``: ``cv | permutation | rsa | tune | grid | update``) that
    normalises and validates eagerly at construction, so malformed traffic
    fails with a clear message instead of a shape error deep inside an eval.
    ``to_dict``/``from_dict`` round-trip the schema (version-stamped; the
    previous schema version is accepted through an explicit upgrade hook)
    for logging, replay, and cross-process submission.
  * **dataset handles** — :meth:`repro_torch.serve.engine.CVEngine.register`
    fingerprints a dataset once and returns a :class:`DatasetHandle` at
    version 0; workloads carry the handle instead of re-shipping the
    feature matrix. ``kind="update"`` workloads append/retire rows through
    the engine's incremental plan math and yield the version n+1 handle.
  * the **unified runner** :func:`run_workloads` — same-plan CV label
    queries coalesce through the engine's
    :class:`~repro_torch.serve.batching.MicroBatcher` (one padded eval
    per group), RSA contrast columns ride the identical column path with
    empirical-RDM memoisation, and permutation / tune / grid workloads
    route to their engine entry points.
  * a **synchronous streaming generator** :func:`stream_workload` — the
    single implementation of chunked permutation/RSA/update progress
    events.
  * a :class:`TrafficLog` — records the (task, bucket) set a serving
    server actually hit, serialisable to JSON, replayable at boot through
    :meth:`~repro_torch.serve.engine.CVEngine.warmup`.

The ``core/`` convenience functions (``binary_cv``, ``analytical_cv``,
``analytical_cv_multiclass``, ``tune_ridge``, ``cv_grid``) remain the
library-level implementations, with parity tests pinning them to this
path.

Where this package differs from the reference's ``serve/workload.py``:

  * a :class:`Workload` knows no device. Its wire form is the
    reference's (``{"__array__": list, "dtype": str}`` for arrays,
    handles and dataset specs alike), decoded arrays are NumPy, and
    :func:`run_workloads` / :func:`stream_workload` move every input to
    the engine's device (``engine.device``) before it reaches a kernel;
  * permutations are drawn from the integer ``seed`` by this package's
    prefix-stable generator (``core.permutation.permutation_indices``: one
    ``permdraw`` launch, the same rows on every device), not by
    ``jax.random``, so the draws differ from the reference's;
  * outputs stay tensors on the engine's device: a coalesced group's
    per-request ``values`` are views of its one eval output.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import fastcv, metrics, multidim, tuning
from repro_torch.core import permutation as perm_lib
from repro_torch.rsa import rdm as rsa_rdm
from repro_torch.serve.batching import as_folds, bucket_size
from repro_torch.serve.trace import NULL_TRACER, attach_trace, trace_of

__all__ = [
    "WORKLOAD_SCHEMA_VERSION",
    "KINDS",
    "DatasetSpec",
    "DatasetHandle",
    "LeastSquaresSpec",
    "register_estimator",
    "get_estimator",
    "estimators",
    "Workload",
    "as_workload",
    "CVResponse",
    "PermutationResponse",
    "RSAResponse",
    "TuneResponse",
    "GridResponse",
    "UpdateResponse",
    "run_workloads",
    "ProgressEvent",
    "stream_workload",
    "TrafficLog",
]

#: Version 2 added ``kind="update"`` and the ``drop_idx`` field; version 1
#: dicts are upgraded transparently by :func:`_upgrade_v1_to_v2`.
WORKLOAD_SCHEMA_VERSION = 2
KINDS = ("cv", "permutation", "rsa", "tune", "grid", "update")

_PERM_ESTIMATORS = ("binary", "multiclass")
_BINARY_METRICS = ("accuracy", "auc")
_CONTRASTS = ("binary", "multiclass")
_DISSIMILARITIES = ("accuracy", "contrast")
_COMPARISONS = ("spearman", "kendall", "pearson", "cosine")
_CRITERIA = ("mse", "error")


def _host(a) -> np.ndarray:
    """``a`` as a NumPy array (a tensor on any device is copied to host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device) -> torch.Tensor:
    """``a`` (a tensor on any device, or array-like) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


# ---------------------------------------------------------------------------
# Datasets: inline specs and registered handles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DatasetSpec:
    """The label-invariant half of a workload: features, folds, λ.

    ``folds`` is a :class:`~repro_torch.core.folds.Folds` or a raw
    ``(te_idx, tr_idx)`` index pair (normalised onto the engine's device by
    ``batching.as_folds``). ``x`` is a tensor or an array (the engine moves
    it to its device); it may be None for ``kind="grid"`` workloads, which
    carry their own feature grid and only borrow the spec's folds and λ.
    """

    x: object
    folds: object
    lam: float
    mode: str = "auto"


@dataclasses.dataclass(frozen=True)
class DatasetHandle:
    """Opaque reference to a dataset registered on a :class:`CVEngine`.

    ``key`` is the content fingerprint ``plan_key(x, folds, λ, mode,
    with_train_block=True, version=version)`` — the same identity the
    :class:`~repro_torch.serve.cache.PlanCache` uses — so a handle survives
    serialisation (:meth:`Workload.to_dict` emits the key) and resolves on
    any engine that registered the same bytes. Workloads carry the handle
    instead of re-shipping the feature matrix.

    ``version`` is 0 for a freshly registered dataset and increments each
    time the engine applies an incremental update (``append``/``retire``/
    a ``kind="update"`` workload); ``n_appended`` counts the rows appended
    over the handle's whole lineage. Old versions remain servable until
    released — in-flight workloads pin the version they were built
    against.
    """

    key: tuple
    n: int = 0
    p: int = 0
    lam: float = 0.0
    mode: str = "auto"
    version: int = 0
    n_appended: int = 0

    def to_dict(self) -> dict:
        return {
            "__handle__": list(self.key),
            "n": self.n,
            "p": self.p,
            "lam": self.lam,
            "mode": self.mode,
            "version": self.version,
            "n_appended": self.n_appended,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DatasetHandle":
        return cls(
            key=tuple(d["__handle__"]),
            n=int(d.get("n", 0)),
            p=int(d.get("p", 0)),
            lam=float(d.get("lam", 0.0)),
            mode=d.get("mode", "auto"),
            version=int(d.get("version", 0)),
            n_appended=int(d.get("n_appended", 0)),
        )


# ---------------------------------------------------------------------------
# Least-squares estimator registry
# ---------------------------------------------------------------------------


def _columns_encode(y, dtype, opts):
    squeeze = y.ndim == 1
    yb = y[:, None] if squeeze else y
    return yb.to(dtype), squeeze


def _columns_test_targets(y, plan, opts):
    return y[plan.te_idx]


def _rows_encode(y, dtype, opts):
    # integer labels as int64: int32 and int64 callers share one launch
    # signature (warm-up's labels are int64)
    if not y.is_floating_point():
        y = y.to(torch.int64)
    squeeze = y.ndim == 1
    return (y[None, :] if squeeze else y), squeeze


def _rows_test_targets(y, plan, opts):
    return y[plan.te_idx] if y.ndim == 1 else y[:, plan.te_idx]


@dataclasses.dataclass(frozen=True)
class LeastSquaresSpec:
    """One registered least-squares model family.

    The registry turns "add a model" from an engine fork into a data
    declaration: how targets are encoded into the shared label-batch
    layout, which evaluator serves it, whether the plan's Eq. 15
    train block is needed, and which metric family scores it.

    Attributes:
      name:         registry key; ``Workload.estimator`` refers to it.
      layout:       "columns" (targets stack along a trailing batch dim,
                    binary/ridge style) or "rows" (label vectors stack
                    along a leading batch dim, multi-class style).
      make_eval:    ``(opts, fused) -> fn[(plan, batch) -> out]`` — a
                    fresh evaluator (the engine memoises one per
                    (eval_key, static opts) and counts the distinct input
                    signatures it serves). ``fused`` asks for the kernel
                    route instead of the Cholesky composite; the engine
                    passes what its device takes. (The reference's
                    factories also take ``donate``, which eager PyTorch
                    has no use for.)
      encode:       ``(y, dtype, opts) -> (batch2d, squeeze)`` target
                    normalisation into the layout.
      test_targets: ``(y, plan, opts) -> y_te`` matching test targets.
      score:        ``(values, y_te, opts) -> scalar`` metric family.
      needs_train:  ``(opts) -> bool`` — True if the eval consumes the
                    plan's H_{Tr,Te} block (paper Eq. 15).
      validate:     ``(y, n, opts) -> None``, raising ValueError with a
                    clear message on malformed targets (before any eval).
      static_opts:  Workload option names that are static to the
                    evaluator (part of the eval-cache identity).
      defaults:     default option values.
      eval_key:     eval-cache identity; estimators sharing an evaluator
                    (e.g. ridge and multi-target ridge both run Eq. 14)
                    share one evaluator by sharing this key.
    """

    name: str
    layout: str
    make_eval: Callable
    encode: Callable = _columns_encode
    test_targets: Callable = _columns_test_targets
    score: Callable = None
    needs_train: Callable = lambda opts: False
    validate: Callable = lambda y, n, opts: None
    static_opts: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    eval_key: str = ""

    def __post_init__(self):
        if self.layout not in ("columns", "rows"):
            raise ValueError(f"layout must be 'columns' or 'rows', got {self.layout!r}")
        if not self.eval_key:
            object.__setattr__(self, "eval_key", self.name)

    def resolve_opts(self, opts: dict) -> dict:
        merged = dict(self.defaults)
        merged.update({k: v for k, v in opts.items() if k in self.defaults})
        return merged

    def static_key(self, opts: dict) -> tuple:
        return tuple((k, opts[k]) for k in self.static_opts)


_ESTIMATORS: dict = {}


def register_estimator(spec: LeastSquaresSpec, *, overwrite: bool = False) -> LeastSquaresSpec:
    """Register a least-squares model family under ``spec.name``.

    Registration is the *entire* integration surface: the runners, the
    micro-batcher, the shape-bucketed eval cache, and the warm-up API
    pick the new estimator up from here.
    """
    if spec.name in _ESTIMATORS and not overwrite:
        raise ValueError(f"estimator {spec.name!r} already registered (pass overwrite=True)")
    _ESTIMATORS[spec.name] = spec
    return spec


def get_estimator(name: str) -> LeastSquaresSpec:
    spec = _ESTIMATORS.get(name)
    if spec is None:
        known = tuple(sorted(_ESTIMATORS))
        raise ValueError(f"unknown estimator {name!r}; registered: {known}")
    return spec


def estimators() -> tuple:
    """Names of all registered least-squares estimators."""
    return tuple(sorted(_ESTIMATORS))


# -- built-in registrations: the paper's three models + multi-target ridge --


def _validate_binary(y, n, opts):
    arr = _host(y)
    if arr.ndim not in (1, 2) or arr.shape[0] != n:
        raise ValueError(f"binary targets must be (N,) or (N, B) with N={n}, got {arr.shape}")
    if not np.all((arr == 1) | (arr == -1)):
        raise ValueError(
            "binary targets must be coded ±1 (paper §2.2); "
            "use estimator='ridge' for continuous responses"
        )


def _validate_ridge(y, n, opts):
    arr = _host(y)
    if arr.ndim not in (1, 2) or arr.shape[0] != n:
        raise ValueError(f"ridge responses must be (N,) or (N, B) with N={n}, got {arr.shape}")


def _validate_multiclass(y, n, opts):
    arr = _host(y)
    c = opts.get("num_classes", 0)
    if c < 2:
        raise ValueError("multiclass workloads need num_classes >= 2")
    if arr.ndim not in (1, 2) or arr.shape[-1] != n:
        raise ValueError(f"multiclass labels must be (N,) or (B, N) with N={n}, got {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"multiclass labels must be integers, got dtype {arr.dtype}")
    if arr.size and (arr.min() < 0 or arr.max() >= c):
        raise ValueError(
            f"multiclass labels must lie in [0, {c}), got range [{arr.min()}, {arr.max()}]"
        )


def _validate_ridge_multi(y, n, opts):
    arr = _host(y)
    if arr.ndim != 2 or arr.shape[0] != n:
        raise ValueError(f"multi-target ridge needs (N, Q) targets with N={n}, got {arr.shape}")


def _score_ridge_multi(values, y_te, opts):
    # Variance-weighted multi-target R² — a genuinely different metric
    # family from single-target MSE, which is the point of the registry.
    v = values.reshape(-1, values.shape[-1])
    t = y_te.to(v.dtype).reshape(-1, y_te.shape[-1])
    ss_res = ((t - v) ** 2).sum(dim=0)
    ss_tot = ((t - t.mean(dim=0, keepdim=True)) ** 2).sum(dim=0)
    return (1.0 - ss_res / torch.clamp(ss_tot, min=torch.finfo(t.dtype).tiny)).mean()


def _make_eval_binary(opts, fused):
    return fastcv.make_eval_binary(adjust_bias=opts["adjust_bias"], fused=fused)


def _make_eval_ridge(opts, fused):
    return fastcv.make_eval_cv(fused=fused)


def _make_eval_multiclass(opts, fused):
    from repro_torch.core import multiclass

    return multiclass.make_eval_multiclass(opts["num_classes"], fused=fused)


def _score_binary(values, y_te, opts):
    return metrics.binary_accuracy(values, y_te)


def _score_ridge(values, y_te, opts):
    return metrics.mse(values, y_te)


def _score_multiclass(values, y_te, opts):
    return metrics.multiclass_accuracy(values, y_te)


def _needs_train_binary(opts):
    return bool(opts["adjust_bias"])


def _needs_train_always(opts):
    return True


register_estimator(
    LeastSquaresSpec(
        name="binary",
        layout="columns",
        make_eval=_make_eval_binary,
        score=_score_binary,
        needs_train=_needs_train_binary,
        validate=_validate_binary,
        static_opts=("adjust_bias",),
        defaults={"adjust_bias": True},
    )
)

register_estimator(
    LeastSquaresSpec(
        name="ridge",
        layout="columns",
        make_eval=_make_eval_ridge,
        score=_score_ridge,
        validate=_validate_ridge,
    )
)

register_estimator(
    LeastSquaresSpec(
        name="multiclass",
        layout="rows",
        make_eval=_make_eval_multiclass,
        encode=_rows_encode,
        test_targets=_rows_test_targets,
        score=_score_multiclass,
        needs_train=_needs_train_always,
        validate=_validate_multiclass,
        static_opts=("num_classes",),
        defaults={"num_classes": 0},
    )
)

# Multi-target ridge shares the ridge evaluator (Eq. 14 over trailing
# columns) — and hence its signature count — via eval_key; only the
# targets contract and the metric family differ.
register_estimator(
    LeastSquaresSpec(
        name="ridge_multi",
        layout="columns",
        make_eval=_make_eval_ridge,
        score=_score_ridge_multi,
        validate=_validate_ridge_multi,
        eval_key="ridge",
    )
)


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CVResponse:
    task: str  # estimator name
    values: torch.Tensor  # dvals / ẏ_Te (K, m[, B]) or preds, on the engine's
    #                       device (a view of the coalesced group's output)
    y_te: torch.Tensor  # matching test labels/responses
    score: torch.Tensor  # the estimator's metric family (accuracy / mse / R²)
    plan_key: tuple
    timings: Optional[dict] = None  # stage -> seconds, tracing only


@dataclasses.dataclass
class PermutationResponse:
    observed: torch.Tensor
    null: torch.Tensor
    p: torch.Tensor
    plan_key: tuple
    timings: Optional[dict] = None  # stage -> seconds, tracing only


@dataclasses.dataclass
class RSAResponse:
    rdm: torch.Tensor  # (C, C) empirical RDM
    pair_values: Optional[torch.Tensor]  # (B,) pair dissimilarities (binary)
    model_scores: Optional[torch.Tensor]  # (M,) or None
    null: Optional[torch.Tensor]  # (M, n_perm) or None
    p: Optional[torch.Tensor]  # (M,) or None
    plan_key: tuple
    timings: Optional[dict] = None  # stage -> seconds, tracing only


@dataclasses.dataclass
class TuneResponse:
    result: tuning.RidgeTuneResult
    timings: Optional[dict] = None  # stage -> seconds, tracing only


@dataclasses.dataclass
class GridResponse:
    accuracies: torch.Tensor  # (Q,) per-grid-point CV accuracy
    timings: Optional[dict] = None  # stage -> seconds, tracing only


@dataclasses.dataclass
class UpdateResponse:
    """Result of a ``kind="update"`` workload: the advanced dataset.

    ``handle`` is the version n+1 :class:`DatasetHandle`; subsequent
    workloads should carry it. ``appended``/``dropped`` count this
    workload's own contribution (coalesced updates share one correction
    but report per-member counts); ``rank`` = appended + dropped is the
    correction rank the engine applied for this member.
    """

    handle: DatasetHandle
    version: int
    appended: int
    dropped: int
    rank: int
    plan_key: tuple
    timings: Optional[dict] = None  # stage -> seconds, tracing only


# ---------------------------------------------------------------------------
# The Workload spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Workload:
    """One versioned, eagerly-validated unit of work against the engine.

    ``kind`` selects the workload family; the remaining fields are that
    family's sub-spec (unused fields are ignored by the runner but still
    validated for coherence):

      cv           dataset + y + estimator (+ estimator options)
      permutation  dataset + y + estimator (binary|multiclass) + null spec
                   (n_perm, seed, metric)
      rsa          dataset + y (condition labels) + contrast spec
                   (num_classes, contrast, dissimilarity, adjust_bias) +
                   optional model spec (model_rdms, comparison, n_perm, seed)
      tune         x + y + lambdas/criterion (exact-LOO ridge tuning; no
                   plan, so no dataset)
      grid         xs (Q, N, P) + y + dataset for folds/λ (the spec's own
                   ``x`` may be None)
      update       dataset (a registered DatasetHandle) + x (rows to
                   append) and/or drop_idx (base-version rows to retire);
                   the engine advances the cached plan by a rank-k
                   correction and returns the version n+1 handle

    ``dataset`` is a :class:`DatasetHandle` (registered; carries no
    feature bytes) or an inline :class:`DatasetSpec` (``kind="update"``
    requires a handle — incremental updates act on registry state).
    Validation runs at construction: shape/coding errors surface here with
    a clear message, never as a shape failure mid-serve. Array fields hold
    tensors (on any device) or arrays; the runner moves them to the
    engine's device.
    """

    kind: str
    dataset: object = None  # DatasetHandle | DatasetSpec | None
    y: object = None
    estimator: str = "binary"
    num_classes: int = 0
    adjust_bias: bool = True
    # null / permutation spec
    n_perm: int = 0
    seed: int = 0
    metric: str = "accuracy"
    # rsa contrast + model spec
    contrast: str = "binary"
    dissimilarity: str = "accuracy"
    model_rdms: object = None
    comparison: str = "spearman"
    # tune spec
    lambdas: object = None
    criterion: str = "mse"
    x: object = None  # tune-kind features / update-kind appended rows
    xs: object = None  # grid-kind (Q, N, P) feature grid
    drop_idx: object = None  # update-kind base-version rows to retire

    def __post_init__(self):
        self.validate()

    # -- validation --------------------------------------------------------

    def _dataset_n(self) -> Optional[int]:
        if isinstance(self.dataset, DatasetHandle):
            return self.dataset.n or None
        if self.dataset is not None and getattr(self.dataset, "x", None) is not None:
            return int(np.shape(self.dataset.x)[0])
        return None

    def estimator_opts(self) -> dict:
        spec = get_estimator(self.estimator)
        opts = {"adjust_bias": self.adjust_bias, "num_classes": self.num_classes}
        return spec.resolve_opts(opts)

    def validate(self) -> "Workload":
        if self.kind not in KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; expected one of {KINDS}")
        getattr(self, f"_validate_{self.kind}")()
        return self

    def _require_dataset(self):
        if self.dataset is None:
            raise ValueError(
                f"kind={self.kind!r} workloads need a dataset (DatasetHandle or DatasetSpec)"
            )
        if not isinstance(self.dataset, DatasetHandle) and not hasattr(self.dataset, "folds"):
            raise TypeError(
                f"dataset must be a DatasetHandle or DatasetSpec-like, "
                f"got {type(self.dataset).__name__}"
            )

    def _validate_cv(self):
        self._require_dataset()
        if self.y is None:
            raise ValueError("cv workloads need targets y")
        spec = get_estimator(self.estimator)
        n = self._dataset_n()
        if n is not None:
            spec.validate(self.y, n, self.estimator_opts())

    def _validate_permutation(self):
        self._require_dataset()
        if self.y is None:
            raise ValueError("permutation workloads need targets y")
        if self.estimator not in _PERM_ESTIMATORS:
            raise ValueError(
                f"permutation workloads support estimators {_PERM_ESTIMATORS}, "
                f"got {self.estimator!r}"
            )
        if self.n_perm <= 0:
            raise ValueError("permutation workloads need n_perm > 0")
        if np.ndim(self.y) != 1:
            raise ValueError("permutation workloads need a single (N,) target vector y")
        if self.estimator == "binary" and self.metric not in _BINARY_METRICS:
            raise ValueError(
                f"binary permutation metric must be one of {_BINARY_METRICS}, "
                f"got {self.metric!r}"
            )
        n = self._dataset_n()
        if n is not None:
            spec = get_estimator(self.estimator)
            spec.validate(self.y, n, self.estimator_opts())

    def _validate_rsa(self):
        self._require_dataset()
        if self.y is None:
            raise ValueError("rsa workloads need condition labels y")
        if self.num_classes < 2:
            raise ValueError("rsa workloads need num_classes >= 2")
        if self.contrast not in _CONTRASTS:
            raise ValueError(f"unknown RSA contrast {self.contrast!r}; expected {_CONTRASTS}")
        if self.dissimilarity not in _DISSIMILARITIES:
            raise ValueError(
                f"unknown RSA dissimilarity {self.dissimilarity!r}; "
                f"expected one of {_DISSIMILARITIES}"
            )
        if self.comparison not in _COMPARISONS:
            raise ValueError(
                f"unknown RDM comparison {self.comparison!r}; expected one of {_COMPARISONS}"
            )
        arr = _host(self.y)
        if arr.ndim != 1:
            raise ValueError(f"rsa condition labels must be (N,), got shape {arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"rsa condition labels must be integers, got {arr.dtype}")
        if arr.size and (arr.min() < 0 or arr.max() >= self.num_classes):
            raise ValueError(f"rsa condition labels must lie in [0, {self.num_classes})")
        if self.model_rdms is not None:
            m = np.shape(self.model_rdms)
            if len(m) != 3 or m[1] != self.num_classes or m[2] != self.num_classes:
                raise ValueError(
                    f"model_rdms must be (M, C, C) with C={self.num_classes}, got shape {m}"
                )

    def _validate_tune(self):
        x = self.x if self.x is not None else getattr(self.dataset, "x", None)
        if x is None:
            raise ValueError("tune workloads need features (x=... or a dataset with x)")
        if self.y is None:
            raise ValueError("tune workloads need targets y")
        if self.criterion not in _CRITERIA:
            raise ValueError(f"tune criterion must be one of {_CRITERIA}, got {self.criterion!r}")
        if np.shape(self.y)[0] != np.shape(x)[0]:
            raise ValueError(f"tune targets length {np.shape(self.y)[0]} != N={np.shape(x)[0]}")

    def _validate_grid(self):
        self._require_dataset()
        if self.xs is None or self.y is None:
            raise ValueError("grid workloads need xs (Q, N, P) and y")
        shape = np.shape(self.xs)
        if len(shape) != 3:
            raise ValueError(f"grid xs must be (Q, N, P), got shape {shape}")
        if shape[1] != np.shape(self.y)[0]:
            raise ValueError(f"grid xs second dim {shape[1]} != len(y) {np.shape(self.y)[0]}")

    def _validate_update(self):
        self._require_dataset()
        if not isinstance(self.dataset, DatasetHandle):
            raise ValueError(
                "update workloads need a registered DatasetHandle — "
                "incremental updates advance registry state, so register() "
                "the dataset first"
            )
        if self.x is None and self.drop_idx is None:
            raise ValueError(
                "update workloads need rows to append (x), rows to retire "
                "(drop_idx), or both"
            )
        if self.x is not None:
            shape = np.shape(self.x)
            if len(shape) != 2:
                raise ValueError(
                    f"update x must be a (k, P) block of appended rows, "
                    f"got shape {shape}"
                )
            if self.dataset.p and shape[1] != self.dataset.p:
                raise ValueError(
                    f"update x has {shape[1]} features but the dataset has "
                    f"P={self.dataset.p}"
                )
        if self.drop_idx is not None:
            arr = _host(self.drop_idx)
            if arr.ndim != 1 or arr.size == 0:
                raise ValueError(
                    f"update drop_idx must be a non-empty 1-D index array, "
                    f"got shape {arr.shape}"
                )
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(
                    f"update drop_idx must be integer row indices, got "
                    f"dtype {arr.dtype}"
                )
            if arr.min() < 0 or (self.dataset.n and arr.max() >= self.dataset.n):
                raise ValueError(
                    f"update drop_idx out of range for the dataset's "
                    f"N={self.dataset.n}"
                )
            if np.unique(arr).size != arr.size:
                raise ValueError("update drop_idx contains duplicate rows")

    # -- versioned serialisation -------------------------------------------

    def to_dict(self) -> dict:
        """Versioned plain-dict form (JSON-serialisable)."""
        d = {
            "schema": WORKLOAD_SCHEMA_VERSION,
            "kind": self.kind,
            "estimator": self.estimator,
            "num_classes": self.num_classes,
            "adjust_bias": self.adjust_bias,
            "n_perm": self.n_perm,
            "seed": self.seed,
            "metric": self.metric,
            "contrast": self.contrast,
            "dissimilarity": self.dissimilarity,
            "comparison": self.comparison,
            "criterion": self.criterion,
        }
        for field in ("y", "model_rdms", "lambdas", "x", "xs", "drop_idx"):
            d[field] = _encode_array(getattr(self, field))
        d["dataset"] = _encode_dataset(self.dataset)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Workload":
        schema = d.get("schema")
        while schema in _SCHEMA_UPGRADES and schema != WORKLOAD_SCHEMA_VERSION:
            d = _SCHEMA_UPGRADES[schema](d)
            schema = d.get("schema")
        if schema != WORKLOAD_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported workload schema version {schema!r} "
                f"(this build speaks {WORKLOAD_SCHEMA_VERSION})"
            )
        return cls(
            kind=d["kind"],
            dataset=_decode_dataset(d.get("dataset")),
            y=_decode_array(d.get("y")),
            estimator=d.get("estimator", "binary"),
            num_classes=int(d.get("num_classes", 0)),
            adjust_bias=bool(d.get("adjust_bias", True)),
            n_perm=int(d.get("n_perm", 0)),
            seed=int(d.get("seed", 0)),
            metric=d.get("metric", "accuracy"),
            contrast=d.get("contrast", "binary"),
            dissimilarity=d.get("dissimilarity", "accuracy"),
            model_rdms=_decode_array(d.get("model_rdms")),
            comparison=d.get("comparison", "spearman"),
            lambdas=_decode_array(d.get("lambdas")),
            criterion=d.get("criterion", "mse"),
            x=_decode_array(d.get("x")),
            xs=_decode_array(d.get("xs")),
            drop_idx=_decode_array(d.get("drop_idx")),
        )


def _upgrade_v1_to_v2(d: dict) -> dict:
    """Schema 1 → 2: ``kind="update"`` and ``drop_idx`` were added; every
    v1 field kept its meaning, so the upgrade just fills the v2 defaults."""
    out = dict(d)
    out["schema"] = 2
    out.setdefault("drop_idx", None)
    return out


_SCHEMA_UPGRADES = {1: _upgrade_v1_to_v2}


def _encode_array(a):
    if a is None:
        return None
    arr = _host(a)
    return {"__array__": arr.tolist(), "dtype": str(arr.dtype)}


def _decode_array(d):
    """A wire array as NumPy: a Workload knows no device (the runner moves
    its arrays to the engine's)."""
    if d is None:
        return None
    return np.asarray(d["__array__"], dtype=np.dtype(d["dtype"]))


def _encode_dataset(ds):
    if ds is None:
        return None
    if isinstance(ds, DatasetHandle):
        return ds.to_dict()
    folds = ds.folds
    if folds is not None:
        te_idx, tr_idx = (folds.te_idx, folds.tr_idx) if hasattr(folds, "te_idx") else folds
        folds = {"te_idx": _host(te_idx).tolist(), "tr_idx": _host(tr_idx).tolist()}
    return {
        "__dataset__": {
            "x": _encode_array(ds.x),
            "folds": folds,
            "lam": float(ds.lam),
            "mode": getattr(ds, "mode", "auto"),
        }
    }


def _decode_dataset(d):
    if d is None:
        return None
    if "__handle__" in d:
        return DatasetHandle.from_dict(d)
    spec = d["__dataset__"]
    folds = spec["folds"]
    if folds is not None:
        # the raw index pair: the engine places it on its device (as_folds)
        folds = (np.asarray(folds["te_idx"], np.int32), np.asarray(folds["tr_idx"], np.int32))
    return DatasetSpec(_decode_array(spec["x"]), folds, spec["lam"], spec.get("mode", "auto"))


def as_workload(obj) -> Workload:
    """Normalise to a :class:`Workload`; anything else is refused."""
    if isinstance(obj, Workload):
        return obj
    raise TypeError(
        f"cannot interpret {type(obj).__name__} as a Workload; construct a "
        "repro_torch.serve.Workload"
    )


# ---------------------------------------------------------------------------
# Unified runner
# ---------------------------------------------------------------------------


def _rdm_memo_key(plan_key, w: Workload):
    diss = w.dissimilarity if w.contrast == "binary" else None
    adj = w.adjust_bias if w.contrast == "binary" else None
    # Drop the trailing with-train-block flag: the same workload may be
    # served from either plan variant (the superset plan satisfies
    # train-block-free requests once resident) with identical RDMs.
    base = plan_key[:-1]
    return (base, fastcv.fingerprint(w.y), w.contrast, diss, adj, w.num_classes)


def _rdm_p_value(scores: torch.Tensor, null: torch.Tensor) -> torch.Tensor:
    """(M,) p-values (1 + #{null >= score}) / (1 + T) of an (M, T) null."""
    exceed = (null >= scores[:, None]).sum(dim=1).to(torch.float64)
    return (1.0 + exceed) / (1.0 + null.shape[1])


def run_workloads(engine, workloads: Sequence, *, return_errors: bool = False) -> list:
    """Serve a batch of workloads; responses align with ``workloads``.

    Same-plan CV label queries coalesce into one padded eval per
    (plan, estimator, static-options) group; RSA contrast columns ride the
    same column path with empirical-RDM memoisation (repeat scoring of the
    same (plan, labels) skips the fold solves entirely); permutation, tune,
    and grid workloads route to their engine entry points. ``update``
    workloads against the same base version coalesce into one rank-k
    correction (appends stack in submission order, drop sets union); every
    member receives the same version n+1 handle with its own
    appended/dropped contribution in the :class:`UpdateResponse`.

    With ``return_errors=True`` a failing workload (conversion error,
    unknown/evicted dataset handle, eval failure) yields its *exception
    object* in the corresponding slot instead of aborting the batch, so
    sibling workloads — including other clients' traffic coalesced into
    the same batch — still get served.

    Every input array moves to the engine's device (``engine.device``)
    before it reaches the engine; the outputs stay there.

    Observability: when the engine's tracer is enabled, every workload
    carries (or gets) a :class:`~repro_torch.serve.trace.Trace`; engine-internal
    spans (cache_lookup, plan_build, eval, null_chunk) fire while that
    trace is *activated* around the calls below, the shared coalesced
    group eval is timed once and attributed to every member as an ``eval``
    span, and the finished trace's per-stage sums attach to the response
    as ``timings``. Tracing off ⇒ all hooks are no-ops and ``timings``
    stays None.
    """
    # reprolint: host-path
    raw = list(workloads)
    device = engine.device
    responses: list = [None] * len(raw)
    tracer = getattr(engine, "tracer", None) or NULL_TRACER
    metrics_reg = getattr(engine, "metrics", None)
    traces: list = [None] * len(raw)
    plan_memo: dict = {}
    # In-flight version pinning: every handle this batch resolves is
    # retained on the engine for the batch's duration, so a concurrent
    # release() of a stale version cannot pull the plan out from under a
    # workload that was built against it.
    retain = getattr(engine, "retain_version", None)
    release = getattr(engine, "release_version", None)
    retained: set = set()

    def fail(i, e: Exception):
        if not return_errors:
            # Propagating aborts the batch: drop the version pins first so
            # a failed batch can't wedge deferred releases forever.
            if release is not None:
                for key in retained:
                    release(key)
                retained.clear()
            raise e
        responses[i] = e

    def plan_for(dataset, with_train_block: bool):
        if isinstance(dataset, DatasetHandle):
            if retain is not None and dataset.key not in retained:
                retain(dataset.key)
                retained.add(dataset.key)
            memo_key = (dataset.key, with_train_block)
        else:
            memo_key = (
                id(dataset.x),
                id(dataset.folds),
                float(dataset.lam),
                dataset.mode,
                with_train_block,
            )
        hit = plan_memo.get(memo_key)
        if hit is None:
            hit = plan_memo[memo_key] = engine.resolve(dataset, with_train_block)
        return hit

    # -- group CV workloads by (plan, estimator, static opts) --------------
    groups: dict = {}
    rsa_groups: dict = {}
    update_groups: dict = {}
    for i, obj in enumerate(raw):
        tr = trace_of(obj)
        if tr is None and tracer.enabled:
            tr = tracer.trace()
        traces[i] = tr
        try:
            with tracer.activate(tr):
                with tracer.span("validate"):
                    w = as_workload(obj)
                    est = w.estimator if w.kind in ("cv", "permutation") else ""
                    if tr is not None:
                        tr.kind, tr.estimator = w.kind, est
                    if metrics_reg is not None:
                        metrics_reg.inc("requests_total", kind=w.kind, estimator=est)
                if w.kind == "cv":
                    with tracer.span("validate"):
                        spec = get_estimator(w.estimator)
                        opts = w.estimator_opts()
                    key, plan = plan_for(w.dataset, spec.needs_train(opts))
                    gkey = (key, w.estimator, spec.static_key(opts))
                    groups.setdefault(gkey, (plan, spec, opts, []))[3].append((i, w))
                elif w.kind == "rsa":
                    needs_train = w.contrast == "multiclass" or w.adjust_bias
                    key, plan = plan_for(w.dataset, needs_train)
                    if w.contrast == "binary":
                        gkey = (key, "binary", w.dissimilarity, w.adjust_bias, w.num_classes)
                    else:
                        gkey = (key, "multiclass", None, None, w.num_classes)
                    rsa_groups.setdefault(gkey, (plan, []))[1].append((i, w))
                elif w.kind == "permutation":
                    needs_train = w.estimator == "multiclass" or w.adjust_bias
                    key, plan = plan_for(w.dataset, needs_train)
                    # Input normalisation (labels -> device tensor) is
                    # validate-stage work; leaving it untraced breaks the
                    # stage-sum ≈ end-to-end invariant.
                    with tracer.span("validate"):
                        yv = tracer.sync(_tensor(w.y, device))
                    if w.estimator == "multiclass":
                        res = engine.permutation_multiclass(
                            plan, yv, w.n_perm, w.seed, num_classes=w.num_classes
                        )
                    else:
                        res = engine.permutation_binary(
                            plan,
                            yv,
                            w.n_perm,
                            w.seed,
                            metric=w.metric,
                            adjust_bias=w.adjust_bias,
                        )
                    with tracer.span("encode"):
                        responses[i] = PermutationResponse(
                            res.observed, res.null, tracer.sync(res.p), key
                        )
                elif w.kind == "tune":
                    x = w.x if w.x is not None else w.dataset.x
                    with tracer.span("validate"):
                        xv, yv = _tensor(x, device), _tensor(w.y, device)
                        lambdas = None if w.lambdas is None else _tensor(w.lambdas, device)
                    res = engine.tune(xv, yv, lambdas=lambdas, criterion=w.criterion)
                    with tracer.span("encode"):
                        responses[i] = TuneResponse(res)
                elif w.kind == "grid":
                    folds, lam = _grid_folds_lam(engine, w.dataset)
                    xs, yv = _tensor(w.xs, device), _tensor(w.y, device)
                    with tracer.span("eval"):
                        grid = tracer.sync(
                            multidim.cv_grid(xs, yv, folds, lam, adjust_bias=w.adjust_bias)
                        )
                    with tracer.span("encode"):
                        responses[i] = GridResponse(grid)
                elif w.kind == "update":
                    # Same-dataset updates coalesce into one rank-k
                    # correction per base version (appends stack, drops
                    # union) — processed after grouping, below.
                    update_groups.setdefault(w.dataset.key, []).append((i, w))
                else:  # unreachable: validate() gates kinds
                    raise ValueError(f"unknown workload kind {w.kind!r}")
        except Exception as e:  # noqa: BLE001 - isolated per workload
            fail(i, e)

    # -- one coalesced eval per CV group -----------------------------------
    batcher = engine.batcher
    for (key, estimator, _static), (plan, spec, opts, members) in groups.items():
        try:
            # The coalesced eval is shared work: time it once — including
            # the label device transfer, since that copy is part of the
            # shared prep — and attribute the whole cost to every member's
            # trace. No trace is active here, so the engine-internal eval
            # span is a no-op — the cost is counted exactly once per trace;
            # the card is synchronised before the clock is read.
            with tracer.shared("eval", [traces[i] for i, _w in members], device):
                ys = [_tensor(w.y, device) for _, w in members]
                run = batcher.run_columns if spec.layout == "columns" else batcher.run_rows
                outs = run(ys, lambda b: engine.eval_estimator(plan, b, estimator, **opts))
        except Exception as e:  # noqa: BLE001 - the whole group shares the eval
            for i, _w in members:
                fail(i, e)
            continue
        for (i, w), values in zip(members, outs):
            try:
                with tracer.activate(traces[i]), tracer.span("encode"):
                    y = _tensor(w.y, device)
                    y_te = spec.test_targets(y, plan, opts)
                    score = tracer.sync(spec.score(values, y_te, opts))
                    responses[i] = CVResponse(estimator, values, y_te, score, key)
            except Exception as e:  # noqa: BLE001 - per-member post-processing
                fail(i, e)

    # -- RSA: contrast columns ride the same coalesced label-batch path ----
    for (key, contrast, diss, adj, c), (plan, members) in rsa_groups.items():
        try:
            with tracer.shared("eval", [traces[i] for i, _w in members], device):
                rdms = _rsa_empirical(engine, key, plan, contrast, diss, adj, c, members)
        except Exception as e:  # noqa: BLE001 - the whole group shares the eval
            for i, _w in members:
                fail(i, e)
            continue
        for (i, w), (rdm, vals) in zip(members, rdms):
            try:
                with tracer.activate(traces[i]):
                    scores = null = p = None
                    if w.model_rdms is not None:
                        with tracer.span("validate"):
                            models = tracer.sync(_tensor(w.model_rdms, device))
                        scores, null, p = engine.compare_rdms(
                            rdm, models, w.comparison, w.n_perm, w.seed
                        )
                    with tracer.span("encode"):
                        responses[i] = RSAResponse(rdm, vals, tracer.sync(scores), null, p, key)
            except Exception as e:  # noqa: BLE001 - per-member model scoring
                fail(i, e)

    # -- one coalesced rank-k correction per updated base version ----------
    for base_key, members in update_groups.items():
        try:
            update_dataset = getattr(engine, "update_dataset", None)
            if update_dataset is None:
                raise TypeError(
                    "this engine does not support kind='update' workloads "
                    "(no update_dataset method)")
            # Appended blocks stack on the engine's device (the rank-k
            # correction runs there); drop sets are small host index arrays.
            x_blocks = [_tensor(w.x, device) for _, w in members if w.x is not None]
            drops = [_host(w.drop_idx) for _, w in members if w.drop_idx is not None]
            x_new = torch.cat(x_blocks) if x_blocks else None  # reprolint: ignore[RL001] -- one cat
            drop_idx = np.concatenate(drops) if drops else None
            with tracer.shared("plan_update", [traces[i] for i, _w in members], device):
                handle = update_dataset(members[0][1].dataset, x_new=x_new, drop_idx=drop_idx)
        except Exception as e:  # noqa: BLE001 - the group shares the update
            for i, _w in members:
                fail(i, e)
            continue
        for i, w in members:
            try:
                with tracer.activate(traces[i]), tracer.span("encode"):
                    appended = 0 if w.x is None else int(np.shape(w.x)[0])
                    dropped = 0 if w.drop_idx is None else int(np.shape(w.drop_idx)[0])
                    responses[i] = UpdateResponse(
                        handle=handle,
                        version=handle.version,
                        appended=appended,
                        dropped=dropped,
                        rank=appended + dropped,
                        plan_key=handle.key,
                    )
            except Exception as e:  # noqa: BLE001 - per-member encode
                fail(i, e)

    # -- close traces; attach per-stage sums to the responses --------------
    for i, resp in enumerate(responses):
        tr = traces[i]
        if tr is None:
            continue
        tracer.finish(tr)
        if resp is not None and not isinstance(resp, Exception):
            resp.timings = tr.timings()
    if release is not None:
        for key in retained:
            release(key)
    return responses


def _synchronize(device) -> None:
    """Wait for the card before a host clock reads the time of work on it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _grid_folds_lam(engine, dataset):
    if isinstance(dataset, DatasetHandle):
        rec = engine.dataset_record(dataset)
        return rec.folds, rec.lam
    return as_folds(dataset.folds, engine.device), float(dataset.lam)


def _rsa_empirical(engine, key, plan, contrast, diss, adj, c, members):
    """(rdm, pair_values) per member, with engine-level RDM memoisation.

    Only cache misses pay fold solves — and they still coalesce into one
    padded batch; hits are filled from
    :attr:`~repro_torch.serve.engine.CVEngine.rdm_cache`.
    """
    device = engine.device
    out: list = [None] * len(members)
    misses = []
    for j, (_i, w) in enumerate(members):
        memo_key = _rdm_memo_key(key, w)
        hit = engine.rdm_cache.get(memo_key)
        if hit is not None:
            out[j] = hit
        else:
            misses.append((j, w, memo_key))
    if misses:
        batcher = engine.batcher
        if contrast == "binary":
            cols = [
                rsa_rdm.pair_contrast_columns(_tensor(w.y, device), c, plan.h.dtype)
                for _, w, _ in misses
            ]
            vals_list = batcher.run_columns(
                cols, lambda b: engine.eval_rsa_pairs(plan, b, diss, adj)
            )
            built = [(rsa_rdm.rdm_from_pair_values(vals, c), vals) for vals in vals_list]
        else:
            ys = [_tensor(w.y, device) for _, w, _ in misses]
            preds = batcher.run_rows(ys, lambda b: engine.eval_multiclass(plan, b, c))
            built = [
                (rsa_rdm.rdm_from_confusion(pred, y[plan.te_idx], c), None)
                for pred, y in zip(preds, ys)
            ]
        for (j, _w, memo_key), value in zip(misses, built):
            engine.rdm_cache.put(memo_key, value)
            out[j] = value
    return out


# ---------------------------------------------------------------------------
# Streaming (synchronous generator)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProgressEvent:
    """One step of a streamed workload.

    kind:    "plan" (payload: plan key), "observed" (payload: observed
             metric), "rdm" (payload: empirical RDM), "scores" (payload:
             model scores), "null" (payload: the new null chunk),
             "update" (payload: per-increment metrics delta dict — rows
             applied, correction rank, new version, seconds), or "done"
             (payload: the final response object).
    done:    permutations finished so far (0 for pre-null events); rows
             applied so far for streamed updates.
    total:   total permutations (or update rows) the stream will produce.
    payload: kind-specific value; always the full response on "done".
    """

    kind: str
    done: int
    total: int
    payload: object


def _chunk_plan(engine, total: int, chunk: int) -> tuple[int, int]:
    buckets = engine.config.buckets
    t_gen = bucket_size(total, buckets)
    chunk = min(bucket_size(chunk, buckets), t_gen)
    # whole chunks, same prefix (permutation_indices is prefix-stable)
    return -(-t_gen // chunk) * chunk, chunk


def _null_chunks(engine, total: int, n_items: int, seed: int, chunk: int, eval_chunk):
    """Shared streaming loop: yield (done, null_block) chunk by chunk.

    Permutations of ``n_items`` are generated once at the bucketed total —
    rounded up to a whole number of chunks, so every slice is a full chunk
    with one static shape even under non-nested custom buckets — and
    evaluated ``chunk`` rows at a time; repeats serve no new shape, and the
    rounding preserves the prefix, so the stream's first ``total`` draws
    match the monolithic path exactly. ``eval_chunk(block, keep)`` trims
    its own output to ``keep``.
    """
    t_gen, chunk = _chunk_plan(engine, total, chunk)
    perms = perm_lib.permutation_indices(seed, n_items, t_gen, device=engine.device)
    for lo in range(0, total, chunk):
        hi = min(lo + chunk, total)
        yield hi, eval_chunk(perms[lo : min(lo + chunk, t_gen)], hi - lo)


def stream_workload(engine, workload, chunk: int = 64) -> Iterator[ProgressEvent]:
    """Generator of :class:`ProgressEvent`\\ s for one workload.

    Permutation workloads emit their null distribution in prefix-stable
    bucket-sized chunks (identical draws to the monolithic
    :meth:`~repro_torch.serve.engine.CVEngine.permutation_binary`); RSA
    workloads emit the empirical RDM, then model scores, then null chunks.
    Any other kind degenerates to a single "done" event wrapping the
    batched response.

    Tracing: the workload's attached trace (or a fresh one when the
    engine's tracer is enabled) is *activated only around engine calls*,
    never across a ``yield`` — a generator suspending inside an activation
    would leak the context var into whatever its consuming thread runs next.
    The final "done" response carries ``timings`` like the batched path.
    """
    tracer = getattr(engine, "tracer", None) or NULL_TRACER
    tr = trace_of(workload)
    if tr is None and tracer.enabled:
        tr = tracer.trace()
    with tracer.activate(tr):
        with tracer.span("validate"):
            w = as_workload(workload)
    if w.kind == "permutation":
        if tr is not None:
            tr.kind, tr.estimator = w.kind, w.estimator
        _count_request(engine, w.kind, w.estimator)
        yield from _stream_permutation(engine, w, chunk, tracer, tr)
    elif w.kind == "rsa":
        if tr is not None:
            tr.kind = w.kind
        _count_request(engine, w.kind, "")
        yield from _stream_rsa(engine, w, chunk, tracer, tr)
    elif w.kind == "update":
        if tr is not None:
            tr.kind = w.kind
        _count_request(engine, w.kind, "")
        yield from _stream_update(engine, w, chunk, tracer, tr)
    else:
        # run_workloads counts the request, picks the trace up from the
        # workload object, and attaches timings itself.
        attach_trace(w, tr)
        (resp,) = run_workloads(engine, [w])
        yield ProgressEvent("done", 1, 1, resp)


def _count_request(engine, kind: str, estimator: str) -> None:
    metrics_reg = getattr(engine, "metrics", None)
    if metrics_reg is not None:
        metrics_reg.inc("requests_total", kind=kind, estimator=estimator)


def _finish_stream(tracer, tr, build_response):
    """Final-event helper: build the response under an ``encode`` span,
    close the trace, and attach its per-stage sums."""
    if tr is None:
        return build_response()
    with tracer.activate(tr), tracer.span("encode"):
        resp = build_response()
    tracer.finish(tr)
    resp.timings = tr.timings()
    return resp


def _stream_permutation(engine, w: Workload, chunk: int, tracer=NULL_TRACER, tr=None):
    # reprolint: host-path
    total = w.n_perm
    needs_train = w.estimator == "multiclass" or w.adjust_bias
    with tracer.activate(tr):
        key, plan = engine.resolve(w.dataset, needs_train)
    yield ProgressEvent("plan", 0, total, key)
    y = _tensor(w.y, engine.device)
    if w.estimator == "multiclass":
        with tracer.activate(tr):
            observed = engine.observed_multiclass(plan, y, num_classes=w.num_classes)

        def eval_chunk(block, keep):
            with tracer.activate(tr):
                return engine.null_multiclass(plan, y, block, num_classes=w.num_classes)[:keep]

    else:
        with tracer.activate(tr):
            observed = engine.observed_binary(
                plan, y, metric=w.metric, adjust_bias=w.adjust_bias
            )

        def eval_chunk(block, keep):
            with tracer.activate(tr):
                return engine.null_binary(
                    plan, y, block, metric=w.metric, adjust_bias=w.adjust_bias
                )[:keep]

    yield ProgressEvent("observed", 0, total, observed)
    chunks = []
    for hi, null_block in _null_chunks(engine, total, int(y.shape[0]), w.seed, chunk, eval_chunk):
        chunks.append(null_block)
        yield ProgressEvent("null", hi, total, null_block)

    def build():
        # the chunks are eval outputs on the device: one cat at the stream's end
        null = torch.cat(chunks)  # reprolint: ignore[RL001] -- chunks on the device
        p = perm_lib.p_value(observed, null)
        return PermutationResponse(observed, null, p, key)

    yield ProgressEvent("done", total, total, _finish_stream(tracer, tr, build))


def _stream_update(engine, w: Workload, chunk: int, tracer=NULL_TRACER, tr=None):
    """Chunked incremental updates: apply the correction in increments.

    The drop set (plus an equal number of appended rows when both are
    present — the sliding-window move) lands as the first increment; any
    remaining appended rows follow in chunks rounded to a whole number of
    folds so every increment keeps per-fold test sizes rectangular. Each
    increment is a real engine update (counters and histograms move per
    increment — the emitted "update" events are metrics deltas), and the
    superseded intermediate versions are released as soon as the next one
    lands; only the base version and the final version survive the stream.
    """
    # reprolint: host-path
    handle = w.dataset
    k_total = 0 if w.x is None else int(np.shape(w.x)[0])
    d_total = 0 if w.drop_idx is None else int(np.shape(w.drop_idx)[0])
    total = k_total + d_total
    yield ProgressEvent("plan", 0, total, handle.key)
    x = None if w.x is None else _tensor(w.x, engine.device)
    increments = []
    lo = 0
    if d_total:
        take = min(k_total, d_total)
        increments.append((None if not take else x[:take], w.drop_idx))
        lo = take
    if lo < k_total:
        rec = getattr(engine, "dataset_record", None)
        n_folds = rec(handle).folds.k if rec is not None else 1
        step = max(n_folds, chunk - chunk % n_folds)
        for start in range(lo, k_total, step):
            increments.append((x[start : start + step], None))
    release = getattr(engine, "release", None)
    cur, prev = handle, None
    applied = 0
    for x_inc, drop_inc in increments:
        k_inc = 0 if x_inc is None else int(x_inc.shape[0])
        d_inc = 0 if drop_inc is None else int(np.shape(drop_inc)[0])
        t0 = time.perf_counter()
        with tracer.activate(tr):
            cur = engine.update_dataset(cur, x_new=x_inc, drop_idx=drop_inc)
        _synchronize(engine.device)
        dt = time.perf_counter() - t0
        if prev is not None and release is not None:
            release(prev, drop_store=True)
        prev = cur
        applied += k_inc + d_inc
        yield ProgressEvent(
            "update",
            applied,
            total,
            {
                "appended": k_inc,
                "dropped": d_inc,
                "rank": k_inc + d_inc,
                "version": cur.version,
                "seconds": dt,
            },
        )

    def build():
        return UpdateResponse(
            handle=cur,
            version=cur.version,
            appended=k_total,
            dropped=d_total,
            rank=total,
            plan_key=cur.key,
        )

    yield ProgressEvent("done", total, total, _finish_stream(tracer, tr, build))


def _stream_rsa(engine, w: Workload, chunk: int, tracer=NULL_TRACER, tr=None):
    # reprolint: host-path
    c = w.num_classes
    total = w.n_perm if w.model_rdms is not None else 0
    needs_train = w.contrast == "multiclass" or w.adjust_bias
    with tracer.activate(tr):
        key, plan = engine.resolve(w.dataset, needs_train)
    yield ProgressEvent("plan", 0, total, key)
    y = _tensor(w.y, engine.device)
    memo_key = _rdm_memo_key(key, w)
    hit = engine.rdm_cache.get(memo_key)
    if hit is not None:
        rdm, vals = hit
    elif w.contrast == "binary":
        with tracer.activate(tr):
            cols = rsa_rdm.pair_contrast_columns(y, c, plan.h.dtype)
            vals = engine.eval_rsa_pairs(plan, cols, w.dissimilarity, w.adjust_bias)
            rdm = rsa_rdm.rdm_from_pair_values(vals, c)
        engine.rdm_cache.put(memo_key, (rdm, vals))
    else:
        with tracer.activate(tr):
            preds = engine.eval_multiclass(plan, y, c)
            rdm, vals = rsa_rdm.rdm_from_confusion(preds, y[plan.te_idx], c), None
        engine.rdm_cache.put(memo_key, (rdm, vals))
    yield ProgressEvent("rdm", 0, total, rdm)
    if w.model_rdms is None:
        resp = _finish_stream(
            tracer, tr, lambda: RSAResponse(rdm, vals, None, None, None, key)
        )
        yield ProgressEvent("done", 0, 0, resp)
        return
    models = _tensor(w.model_rdms, engine.device)
    with tracer.activate(tr):
        scores = engine.score_rdms(rdm, models, w.comparison)
    yield ProgressEvent("scores", 0, total, scores)
    if total <= 0:
        resp = _finish_stream(
            tracer, tr, lambda: RSAResponse(rdm, vals, scores, None, None, key)
        )
        yield ProgressEvent("done", 0, 0, resp)
        return

    def eval_chunk(block, keep):
        with tracer.activate(tr):
            return engine.null_rdm_scores(rdm, models, block, w.comparison)[:, :keep]

    chunks = []
    for hi, null_block in _null_chunks(engine, total, c, w.seed, chunk, eval_chunk):
        chunks.append(null_block)
        yield ProgressEvent("null", hi, total, null_block)

    def build():
        # the p-value of CVEngine.compare_rdms, over the concatenated chunks
        null = torch.cat(chunks, dim=1)  # reprolint: ignore[RL001] -- chunks on the device
        return RSAResponse(rdm, vals, scores, null, _rdm_p_value(scores, null), key)

    yield ProgressEvent("done", total, total, _finish_stream(tracer, tr, build))


# ---------------------------------------------------------------------------
# Traffic recording: the observed (task, bucket) set, replayable at boot
# ---------------------------------------------------------------------------


class TrafficLog:
    """The (task, bucket) set a server's traffic actually hit.

    :meth:`record` takes every submitted workload's warm-up coordinates —
    eval task, label-batch bucket, and the static options the evaluator
    depends on — into a dedup'd set. ``save``/``load`` round-trip it as
    JSON (the reference's format), and :meth:`replay` feeds it back
    through :meth:`~repro_torch.serve.engine.CVEngine.warmup`, so a boot
    sequence serves every launch shape yesterday's traffic needed once.

    Buckets are recorded *per workload*. Batch paths that coalesce many
    workloads into one padded eval serve the coalesced width, which
    depends on traffic timing — replaying a per-workload log warms every
    individual shape (and the deterministic permutation/RSA buckets) but
    may still leave a first signature for a novel coalesced composition.
    """

    _TASKS = {
        "binary": "binary",
        "ridge": "ridge",
        "ridge_multi": "ridge",
        "multiclass": "multiclass",
    }

    def __init__(self, entries: Optional[Sequence[dict]] = None):
        self._entries: set = set()
        for e in entries or ():
            self._entries.add(tuple(sorted(e.items())))

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list[dict]:
        """The entries by (task, bucket), ties broken by the whole entry's
        JSON: an order set by the content alone, so ``save`` → ``load`` →
        ``save`` gives the same bytes whatever the process's hash seed."""
        return sorted((dict(e) for e in self._entries),
                      key=lambda d: (d["task"], d["bucket"], json.dumps(d, sort_keys=True)))

    def _add(self, **fields) -> None:
        self._entries.add(tuple(sorted(fields.items())))

    def record(
        self, workload: Workload, buckets: Sequence[int], stream_chunk: Optional[int] = None
    ) -> None:
        """Record one workload's warm-up coordinates.

        ``stream_chunk`` (set by ``Client.stream``) additionally records
        the chunk-sized null bucket a *streamed* permutation/RSA workload
        evaluates at, so replay also warms the chunk program.
        """
        w = as_workload(workload)
        chunk = None
        if stream_chunk is not None and w.n_perm > 0:
            chunk = min(bucket_size(stream_chunk, buckets), bucket_size(w.n_perm, buckets))
        if w.kind == "cv":
            task = self._TASKS.get(w.estimator)
            if task is None:
                return  # third-party estimators: no warm-up task mapping
            if np.ndim(w.y) == 1:
                width = 1
            elif get_estimator(w.estimator).layout == "columns":
                width = np.shape(w.y)[1]
            else:
                width = np.shape(w.y)[0]
            self._add(
                task=task,
                bucket=bucket_size(width, buckets),
                num_classes=w.num_classes if task == "multiclass" else 0,
                adjust_bias=w.adjust_bias if task == "binary" else True,
            )
        elif w.kind == "permutation":
            entry = dict(
                task="permutation",
                num_classes=w.num_classes if w.estimator == "multiclass" else 0,
                metric=w.metric if w.estimator == "binary" else "accuracy",
                adjust_bias=w.adjust_bias if w.estimator == "binary" else True,
            )
            self._add(bucket=bucket_size(w.n_perm, buckets), **entry)
            if chunk is not None:
                self._add(bucket=chunk, **entry)
        elif w.kind == "rsa":
            n_pairs = w.num_classes * (w.num_classes - 1) // 2
            entry = dict(
                task="rsa",
                num_classes=w.num_classes,
                dissimilarity=w.dissimilarity,
                adjust_bias=w.adjust_bias,
            )
            if w.contrast == "binary" and n_pairs:
                self._add(bucket=bucket_size(n_pairs, buckets), **entry)
            else:
                # confusion contrast: one Algorithm-2 row through the
                # multiclass eval — warm that program, not the pair path
                self._add(task="multiclass", bucket=1, num_classes=w.num_classes, adjust_bias=True)
            if w.model_rdms is not None and w.n_perm > 0:
                model_entry = dict(
                    comparison=w.comparison,
                    num_model_rdms=int(np.shape(w.model_rdms)[0]),
                    **entry,
                )
                self._add(bucket=bucket_size(w.n_perm, buckets), **model_entry)
                if chunk is not None:
                    self._add(bucket=chunk, **model_entry)
        # tune/grid build no plans: nothing to warm; update runs no
        # bucketed evaluator, so it records nothing either

    # -- persistence -------------------------------------------------------

    #: Schema versions this build replays. Entries are (task, bucket)
    #: coordinate dicts whose meaning is unchanged since v1, so old
    #: recorded logs keep warming new builds.
    _ACCEPTED_SCHEMAS = (1, WORKLOAD_SCHEMA_VERSION)

    def to_json(self) -> str:
        return json.dumps({"schema": WORKLOAD_SCHEMA_VERSION, "entries": self.entries()}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrafficLog":
        d = json.loads(text)
        if d.get("schema") not in cls._ACCEPTED_SCHEMAS:
            raise ValueError(f"unsupported traffic-log schema {d.get('schema')!r}")
        return cls(d["entries"])

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "TrafficLog":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- replay ------------------------------------------------------------

    def replay(self, engine, dataset, *, pin: bool = False) -> list[dict]:
        """Warm ``engine`` for ``dataset`` from the recorded traffic.

        One :meth:`~repro_torch.serve.engine.CVEngine.warmup` call per
        recorded entry; returns the warm-up summaries.
        """
        summaries = []
        for e in self.entries():
            kw = dict(
                tasks=(e["task"],),
                buckets=(e["bucket"],),
                pin=pin,
                num_classes=e.get("num_classes", 0),
                adjust_bias=e.get("adjust_bias", True),
            )
            if e["task"] == "permutation":
                kw["metric"] = e.get("metric", "accuracy")
            if e["task"] == "rsa":
                kw.update(
                    dissimilarity=e.get("dissimilarity", "accuracy"),
                    comparison=e.get("comparison", "spearman"),
                    num_model_rdms=e.get("num_model_rdms", 0),
                )
                if kw["num_model_rdms"] and kw["num_classes"] < 2:
                    kw["num_classes"] = 2
            summaries.append(engine.warmup(dataset, **kw))
        return summaries
