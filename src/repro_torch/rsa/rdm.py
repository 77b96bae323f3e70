"""Cross-validated representational dissimilarity matrices (RDMs).

The paper names Representational Similarity Analysis as a headline
application of analytical CV (§1, §4.2): once the hat matrix and per-fold
factorisations are built, *every* contrast between conditions is just
another label column through the cached fold solves, at O(K·m²) each.

Conditions are integer labels ``y_cond ∈ [0, C)`` over the N samples; the
empirical RDM is built from one shared :class:`~repro_torch.core.fastcv.CVPlan`:

* **binary contrasts** — each of the B = C(C−1)/2 condition pairs (a, b)
  becomes one ±1/0 label column (+1 on a's samples, −1 on b's, 0
  elsewhere). All B columns ride a *single* batched fold solve (on CUDA one
  ``hat_apply`` + ``foldsolve``, or one ``fold_eval`` without the bias
  adjust), and each pair's dissimilarity is scored from the
  cross-validated decision values: ``"accuracy"`` (cross-validated
  pairwise decodability, with the paper's §2.5 LDA bias correction from
  the training-fold decision values) or ``"contrast"`` (the
  cross-validated mean decision-value contrast).
* **multi-class contrasts** — one Algorithm-2 multi-class CV run; the RDM
  is the symmetrised confusion dissimilarity 1 − (p(b|a) + p(a|b))/2.

Non-cross-validated baselines (condition-mean Euclidean RDMs, also the
usual way to *construct* model RDMs from feature embeddings) run on the
hand-written ``pairdist`` kernel for a CUDA tensor. Searchlight sweeps,
Q independent RDM problems, shard over a mesh's problem axes through
:func:`repro_torch.core.distributed.sharded_problems`.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import fastcv, metrics, multiclass
from repro_torch.core.distributed import sharded_problems
from repro_torch.core.folds import Folds
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.pairdist.ops import pairwise_sq_dists

__all__ = [
    "RDMCache",
    "condition_pairs",
    "pair_contrast_columns",
    "pair_dissimilarities",
    "rdm_from_pair_values",
    "rdm_binary",
    "rdm_from_confusion",
    "rdm_multiclass",
    "condition_means",
    "ring_rdm",
    "euclidean_rdm",
    "searchlight_rdm",
    "make_eval_pairs",
]

_DISSIMILARITIES = ("accuracy", "contrast")


class RDMCache:
    """Memoised empirical RDMs, keyed by (plan, labels-fingerprint, spec).

    An empirical RDM is a pure function of the plan (features × folds × λ)
    and the condition labels, so repeated model-RDM scoring against the
    same data can skip the fold solves entirely. Entries hold
    ``(rdm, pair_values)`` tuples. Bounded LRU: RDMs are tiny (C², not
    N²), so an entry *count* cap is the right unit. Locked: get and put may
    come from different threads.
    """

    def __init__(self, max_entries: int = 256):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def condition_pairs(num_classes: int) -> np.ndarray:
    """Static (B, 2) int32 array of condition pairs, B = C(C−1)/2.

    Row order is the upper-triangle order of ``np.triu_indices`` — the
    same order :func:`rdm_from_pair_values` scatters back from and
    ``repro_torch.rsa.compare.upper_triangle`` vectorises RDMs into.
    """
    a, b = np.triu_indices(num_classes, 1)
    return np.stack([a, b], axis=1).astype(np.int32)


def _pairs_on(num_classes: int, device) -> tuple:
    pairs = torch.from_numpy(condition_pairs(num_classes).astype(np.int64)).to(device)
    return pairs[:, 0], pairs[:, 1]


def pair_contrast_columns(y_cond: torch.Tensor, num_classes: int,
                          dtype=torch.float64) -> torch.Tensor:
    """(N, B) matrix of ±1/0 pairwise contrast columns.

    Column j encodes pair (a, b) = ``condition_pairs(C)[j]``: +1 on
    samples of condition a, −1 on b, 0 elsewhere.
    """
    oh = multiclass.onehot(y_cond, num_classes, dtype=dtype)   # (N, C)
    a, b = _pairs_on(num_classes, y_cond.device)
    return oh[:, a] - oh[:, b]                                  # (N, B)


def pair_dissimilarities(
    plan: fastcv.CVPlan,
    cols: torch.Tensor,
    dissimilarity: str = "accuracy",
    adjust_bias: bool = True,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Per-column dissimilarity from one batched fold solve. cols: (N, B).

    The contrast columns double as test/train masks: ``cols[te_idx]`` is
    the ±1/0 test label of every (fold, sample, pair), so scoring needs no
    side-channel condition information.

    ``"accuracy"``: sign agreement of the bias-adjusted decision values
    with the ±1 labels, restricted to the pair's own test samples.
    ``"contrast"``: mean decision value over the pair's positive test
    samples minus the mean over its negative ones.

    Without the bias adjust the train blocks are not needed, so they are
    dropped from the plan before the solve (as the reference's serving
    engine does): on CUDA the columns then take the fused ``fold_eval``
    kernel. ``fused`` as in ``fastcv.cv_errors``.
    """
    if dissimilarity not in _DISSIMILARITIES:
        raise ValueError(f"dissimilarity must be one of {_DISSIMILARITIES}")
    cols = cols.to(plan.h.dtype).contiguous()
    if not adjust_bias and plan.h_tr_te is not None:
        plan = dataclasses.replace(plan, h_tr_te=None)
    y_dot_te, y_dot_tr = fastcv.cv_errors(plan, cols, fused=fused)   # (K, m, B)
    te_lab = cols[plan.te_idx]                                       # (K, m, B)
    dv = y_dot_te
    if adjust_bias:
        if y_dot_tr is None:
            raise ValueError("plan must be prepared with with_train_block=True")
        tr_lab = cols[plan.tr_idx]                                   # (K, N-m, B)
        pos = (tr_lab > 0).to(cols.dtype)
        neg = (tr_lab < 0).to(cols.dtype)
        mu1 = (y_dot_tr * pos).sum(dim=1) / torch.clamp(pos.sum(dim=1), min=1.0)  # (K, B)
        mu2 = (y_dot_tr * neg).sum(dim=1) / torch.clamp(neg.sum(dim=1), min=1.0)
        dv = dv - 0.5 * (mu1 + mu2)[:, None, :]
    if dissimilarity == "accuracy":
        mask = (te_lab.abs() > 0).to(cols.dtype)
        pred = torch.where(dv >= 0, 1.0, -1.0).to(cols.dtype)
        hit = torch.where(mask > 0, (pred == te_lab).to(cols.dtype), 0.0)
        return hit.sum(dim=(0, 1)) / torch.clamp(mask.sum(dim=(0, 1)), min=1.0)
    pos = (te_lab > 0).to(cols.dtype)
    neg = (te_lab < 0).to(cols.dtype)
    m_pos = (dv * pos).sum(dim=(0, 1)) / torch.clamp(pos.sum(dim=(0, 1)), min=1.0)
    m_neg = (dv * neg).sum(dim=(0, 1)) / torch.clamp(neg.sum(dim=(0, 1)), min=1.0)
    return m_pos - m_neg


def rdm_from_pair_values(values: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Scatter (B,) pair values into a symmetric (C, C) RDM, zero diagonal."""
    a, b = _pairs_on(num_classes, values.device)
    rdm = torch.zeros((num_classes, num_classes), dtype=values.dtype, device=values.device)
    rdm[a, b] = values
    return rdm + rdm.T


def rdm_binary(
    x: torch.Tensor,
    y_cond: torch.Tensor,
    folds: Folds,
    num_classes: int,
    lam: float = 1.0,
    *,
    dissimilarity: str = "accuracy",
    adjust_bias: bool = True,
    mode: str = "auto",
    plan: Optional[fastcv.CVPlan] = None,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """One-shot cross-validated pairwise-contrast RDM. Returns (C, C).

    Builds (or reuses) a single plan over all N samples and evaluates all
    C(C−1)/2 contrasts as one label batch.
    """
    if plan is None:
        plan = fastcv.prepare(x, folds, lam, mode=mode, with_train_block=adjust_bias)
    cols = pair_contrast_columns(y_cond, num_classes, plan.h.dtype)
    vals = pair_dissimilarities(plan, cols, dissimilarity=dissimilarity,
                                adjust_bias=adjust_bias, fused=fused)
    return rdm_from_pair_values(vals, num_classes)


# ---------------------------------------------------------------------------
# Multi-class (confusion) contrasts
# ---------------------------------------------------------------------------


def rdm_from_confusion(preds: torch.Tensor, y_te: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """Symmetrised confusion-dissimilarity RDM from CV predictions.

    d(a, b) = 1 − (p(pred=b | true=a) + p(pred=a | true=b)) / 2 for a ≠ b,
    0 on the diagonal. Conditions the classifier confuses often are
    representationally close.
    """
    conf = metrics.confusion_matrix(preds.reshape(-1), y_te.reshape(-1),
                                    num_classes).to(torch.float64)
    rates = conf / torch.clamp(conf.sum(dim=1, keepdim=True), min=1.0)
    sim = 0.5 * (rates + rates.T)
    eye = torch.eye(num_classes, dtype=torch.bool, device=conf.device)
    return torch.where(eye, 0.0, 1.0 - sim)


def rdm_multiclass(plan: fastcv.CVPlan, y_cond: torch.Tensor, num_classes: int, *,
                   fused: Optional[bool] = None) -> torch.Tensor:
    """Confusion RDM from one Algorithm-2 multi-class CV run on the plan."""
    preds = multiclass.batch_predict(plan, y_cond[None, :], num_classes, fused=fused)[0]
    return rdm_from_confusion(preds, y_cond[plan.te_idx], num_classes)


# ---------------------------------------------------------------------------
# Non-cross-validated pattern RDMs (condition means / model-RDM building)
# ---------------------------------------------------------------------------


def condition_means(x: torch.Tensor, y_cond: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, P) mean feature pattern per condition."""
    oh = multiclass.onehot(y_cond, num_classes, dtype=x.dtype)   # (N, C)
    counts = torch.clamp(oh.sum(dim=0), min=1.0)
    return (oh.T @ x) / counts[:, None]


def ring_rdm(num_classes: int, dtype=torch.float64, *, device=None) -> torch.Tensor:
    """(C, C) circular-distance model RDM: d(a, b) = min(|a−b|, C−|a−b|).

    The standard "ring" candidate structure for ordered condition sets
    (orientations, positions, phases). ``device=None`` means ``cuda``.
    """
    idx = torch.arange(num_classes, device=resolve_device(device))
    d = (idx[:, None] - idx[None, :]).abs()
    return torch.minimum(d, num_classes - d).to(dtype)


def euclidean_rdm(patterns: torch.Tensor) -> torch.Tensor:
    """(C, C) squared-Euclidean RDM over row patterns: the ``pairdist``
    kernel for a CUDA tensor, its plain version for a CPU one."""
    return pairwise_sq_dists(patterns.contiguous())


# ---------------------------------------------------------------------------
# Searchlight sweeps: Q independent RDM problems over the mesh
# ---------------------------------------------------------------------------


def searchlight_rdm(
    xs: torch.Tensor,
    y_cond: torch.Tensor,
    folds: Folds,
    lam: float,
    mesh,
    *,
    num_classes: int,
    dissimilarity: str = "accuracy",
    adjust_bias: bool = True,
    mode: str = "auto",
    problem_axes: tuple = ("pod", "data"),
) -> torch.Tensor:
    """Per-searchlight RDMs: xs (Q, N, P_local) → (Q, C, C).

    Each problem builds its own plan and scores all pairwise contrasts on
    its rank; problems shard over the mesh's problem axes with no traffic
    between them (the ``core.distributed`` problem-axis decomposition,
    paper §4.2). A collective call: see ``core.distributed``.
    """

    def one_problem(x):
        return rdm_binary(x, y_cond, folds, num_classes, lam, dissimilarity=dissimilarity,
                          adjust_bias=adjust_bias, mode=mode)

    return sharded_problems(one_problem, xs, mesh, problem_axes=problem_axes)


# ---------------------------------------------------------------------------
# Serving support
# ---------------------------------------------------------------------------


def make_eval_pairs(dissimilarity: str = "accuracy", adjust_bias: bool = True,
                    fused: Optional[bool] = None):
    """Evaluator ``(plan, cols (N, B)) -> (B,) dissimilarities``; ``fused``
    as in ``fastcv.cv_errors``."""
    return functools.partial(pair_dissimilarities, dissimilarity=dissimilarity,
                             adjust_bias=adjust_bias, fused=fused)
