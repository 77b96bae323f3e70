"""Analytical k-fold cross-validation for least-squares models.

The paper's primary contribution (Treder 2018, §2.4-2.6): exact
cross-validated decision values for any ridge-regularised least-squares
model (linear regression, ridge regression, binary LDA in regression form)
from a *single* full-data fit.

    H  = X̃ (X̃ᵀX̃ + λI₀)⁻¹ X̃ᵀ          (hat matrix, Eq. 8 + §2.6.1)
    ŷ  = H y,   ê = y − ŷ
    ė_Te = (I − H_Te)⁻¹ ê_Te            (Eq. 14 — the analytical approach)
    ẏ_Te = y_Te − ė_Te
    ė_Tr = ê_Tr + H_{Tr,Te} (I − H_Te)⁻¹ ê_Te        (Eq. 15, bias adjust)

Two hat-matrix paths, selected by shape: *primal* (N > P), the paper's
augmented form with the unpenalised-intercept matrix I₀; and *dual* (P ≫ N,
the paper's own regime), ``H = 1/N·11ᵀ + G_c (G_c + λI)⁻¹`` with
``G_c = X_c X_cᵀ``, which only ever materialises N×N objects. The O(N²P)
Gram product is the hand-written ``gram`` kernel's on a CUDA tensor.

Two eval routes, chosen by ``fused`` (``None`` resolves to the kernels on
CUDA and to the composite on the CPU, ``kernels.common.default_fused``):
the reference's batched-Cholesky composite (``fused=False``), and the
kernel route (:func:`cv_errors_fused`) — ``fold_eval`` for plans without
train blocks; ``hat_apply`` then ``foldsolve`` for plans with them.

Eager PyTorch has no buffer donation, so the reference's ``donate``
options have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.folds import Folds
from repro_torch.kernels.common import default_fused, resolve_device
from repro_torch.kernels.fold_eval.ops import fold_eval
from repro_torch.kernels.foldsolve.ops import foldsolve
from repro_torch.kernels.gram.ops import centered_gram, check_precision
from repro_torch.kernels.hat_apply.ops import hat_errors

__all__ = [
    "hat_matrix",
    "hat_matrix_primal",
    "hat_matrix_dual",
    "CVPlan",
    "prepare",
    "cv_errors",
    "cv_errors_fused",
    "binary_dvals",
    "binary_cv",
    "fingerprint",
    "plan_key",
    "PLAN_FIELDS",
    "plan_to_arrays",
    "plan_from_arrays",
    "make_eval_binary",
    "make_eval_cv",
]


def _augment(x: torch.Tensor) -> torch.Tensor:
    """X̃ = [X, 1] — append the intercept column (paper §2.3)."""
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1)


def _i0(p1: int, like: torch.Tensor) -> torch.Tensor:
    """I₀: identity with the intercept entry zeroed (bias never penalised)."""
    i0 = torch.eye(p1, dtype=like.dtype, device=like.device)
    i0[p1 - 1, p1 - 1] = 0.0
    return i0


def hat_matrix_primal(x: torch.Tensor, lam: float = 0.0) -> torch.Tensor:
    """H = X̃ (X̃ᵀX̃ + λI₀)⁻¹ X̃ᵀ — the paper's explicit form, O(NP² + P³)."""
    xa = _augment(x)
    a = xa.T @ xa + lam * _i0(xa.shape[1], x)
    return (xa @ torch.cholesky_solve(xa.T, torch.linalg.cholesky(a))).contiguous()


def hat_matrix_dual(x: torch.Tensor, lam: float,
                    gram: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H = 1/N·11ᵀ + G_c (G_c + λI)⁻¹, G_c = X_c X_cᵀ — dual / kernel form.

    O(N²P + N³); never materialises a P×P matrix. Exact for λ > 0.
    ``gram`` may be supplied precomputed (e.g. by the ``gram`` kernel).
    """
    n = x.shape[0]
    if gram is None:
        xc = x - x.mean(dim=0, keepdim=True)
        gram = xc @ xc.T
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    h_c = torch.cholesky_solve(gram, torch.linalg.cholesky(gram + lam * eye))
    # G (G+λI)⁻¹ is symmetric (G and (G+λI)⁻¹ share an eigenbasis).
    h_c = 0.5 * (h_c + h_c.T)
    # cholesky_solve returns column-major; the kernels take row-major H.
    return (h_c + 1.0 / n).contiguous()


def _resolve_mode(x: torch.Tensor, mode: str) -> str:
    n, p = x.shape
    return ("dual" if p >= n else "primal") if mode == "auto" else mode


def hat_matrix(x: torch.Tensor, lam: float = 0.0, mode: str = "auto",
               gram: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch between primal and dual hat-matrix construction.

    mode="auto" picks dual when P >= N, primal otherwise. λ = 0 in the
    P >= N regime is rejected: the unregularised interpolator has H_Te → I
    and Eq. (14) becomes singular.
    """
    mode = _resolve_mode(x, mode)
    if mode == "dual":
        if lam <= 0.0:
            raise ValueError("dual hat matrix requires lam > 0 (P >= N regime)")
        return hat_matrix_dual(x, lam, gram=gram)
    if mode == "primal":
        return hat_matrix_primal(x, lam)
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# CV plan: everything that depends on (X, folds, λ) but not on labels.
# Reused across permutations (§2.7: H is label-invariant).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CVPlan:
    """Precomputed label-independent quantities for analytical CV.

    Attributes:
      h: (N, N) hat matrix.
      te_idx: (K, m) test indices.  tr_idx: (K, N-m) train indices.
      chol_ih: (K, m, m) Cholesky factors (lower) of I − H_Te per fold.
      h_tr_te: (K, N-m, m) cross blocks H_{Tr,Te} (None unless bias adjust).
    """

    h: torch.Tensor
    te_idx: torch.Tensor
    tr_idx: torch.Tensor
    chol_ih: torch.Tensor
    h_tr_te: Optional[torch.Tensor]

    @property
    def k(self) -> int:
        return self.te_idx.shape[0]

    @property
    def nbytes(self) -> int:
        """Device bytes held by the plan — the plan-cache accounting unit."""
        leaves = [getattr(self, name) for name in PLAN_FIELDS]
        return int(sum(t.numel() * t.element_size() for t in leaves if t is not None))


def _fold_blocks(h: torch.Tensor, te: torch.Tensor) -> torch.Tensor:
    """(K, m, m) diagonal fold blocks H_Te."""
    return h[te[:, :, None], te[:, None, :]]


def prepare(x: torch.Tensor, folds: Folds, lam: float = 0.0, mode: str = "auto",
            with_train_block: bool = True,
            gram: Optional[torch.Tensor] = None,
            precision: Optional[str] = None) -> CVPlan:
    """Build a :class:`CVPlan`: hat matrix + per-fold factorisations.

    The one-time O(N²P + N³ + K·m³) setup; every later label vector (CV run
    or permutation) costs O(K·m²) per evaluation.

    In dual mode the centered Gram G_c comes from ``gram`` when given, else
    from ``kernels.gram.ops.centered_gram``: the ``gram`` kernel on a CUDA
    tensor, the plain composite on a CPU one. ``precision="bf16_gram"``
    (dual mode only) builds that product from a bf16 cast of the centered
    design with f32 accumulation; every solve stays full precision. A
    caller-supplied ``gram`` is trusted to honour the requested precision.
    """
    mode = _resolve_mode(x, mode)
    if mode == "dual" and lam <= 0.0:
        raise ValueError("analytical CV with P >= N requires lam > 0 "
                         "(unregularised interpolation makes I - H_Te singular)")
    if gram is not None and mode != "dual":
        raise ValueError("precomputed gram only applies to dual mode")
    precision = check_precision(precision)
    if precision != "fp32" and mode != "dual":
        raise ValueError(
            f"precision={precision!r} only applies to dual-mode plans "
            "(the primal build has no Gram product to down-cast)")
    if mode == "dual" and gram is None:
        gram = centered_gram(x, precision=precision)
    h = hat_matrix(x, lam, mode=mode, gram=gram)
    te, tr = folds.te_idx, folds.tr_idx
    h_te = _fold_blocks(h, te)
    eye = torch.eye(h_te.shape[-1], dtype=h.dtype, device=h.device)
    # A fold whose I − H_Te is not numerically SPD gets a NaN factor, as the
    # reference's cho_factor gives: the composite route then yields NaN for
    # that fold, and the kernel route (which never reads chol_ih) is unharmed.
    chol, info = torch.linalg.cholesky_ex(eye - h_te)
    chol = torch.where((info != 0)[:, None, None], torch.nan, chol)
    h_tr_te = h[tr[:, :, None], te[:, None, :]] if with_train_block else None
    return CVPlan(h, te, tr, chol, h_tr_te)


def cv_errors(plan: CVPlan, y: torch.Tensor, *, fused: Optional[bool] = None):
    """Eq. (14) + Eq. (15) for a label/response matrix ``y`` of shape (N, ...).

    Returns (y_dot_te, y_dot_tr):
      y_dot_te: (K, m, ...)    exact CV predictions on each test fold.
      y_dot_tr: (K, N-m, ...)  exact *training-set* predictions of each
                               fold model (None if plan lacks train blocks).

    ``fused=None`` takes the kernel route (:func:`cv_errors_fused`) on CUDA
    and the batched-Cholesky composite on the CPU; ``False`` asks for the
    composite anywhere, ``True`` for the kernel route anywhere (on the CPU
    it runs the kernels' plain versions).
    """
    if default_fused(plan.h.device) if fused is None else fused:
        return cv_errors_fused(plan, y)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    e_hat = y - plan.h @ y                                     # (N, B)
    t = torch.cholesky_solve(e_hat[plan.te_idx], plan.chol_ih)  # (I−H_Te)⁻¹ ê_Te
    y_dot_te = y[plan.te_idx] - t                              # ẏ_Te = y_Te − ė_Te
    y_dot_tr = None
    if plan.h_tr_te is not None:
        e_dot_tr = e_hat[plan.tr_idx] + torch.bmm(plan.h_tr_te, t)
        y_dot_tr = y[plan.tr_idx] - e_dot_tr
    if squeeze:
        y_dot_te = y_dot_te[..., 0]
        y_dot_tr = None if y_dot_tr is None else y_dot_tr[..., 0]
    return y_dot_te, y_dot_tr


def cv_errors_fused(plan: CVPlan, y: torch.Tensor):
    """Kernel evaluation route; same contract as :func:`cv_errors`.

    Plans without train blocks take the fused ``fold_eval`` kernel: the
    hat-row contraction and the fold solves run in one launch. Plans *with*
    train blocks (bias adjust) need Ê on every training row for Eq. (15),
    so Ê = Y − H·Y comes from the ``hat_apply`` kernel and the fold solves
    from the ``foldsolve`` kernel. Both solve I − H_Te directly
    (Gauss–Jordan) rather than use the plan's Cholesky factors, and each
    is one launch with its residual-checked jitter retry inside.
    """
    squeeze = y.ndim == 1
    y = (y[:, None] if squeeze else y).contiguous()
    if y.dtype == torch.float32 and y.data_ptr() % 16:
        # a contiguous view can start at any element, such as a row of a
        # (T, N) label tensor; hat_apply's f32 route copies Y in aligned
        # 16-byte pieces, so such labels are copied to fresh storage first
        # (the f64 route takes any 8-byte offset)
        y = y.clone()
    te = plan.te_idx
    h_te = _fold_blocks(plan.h, te)                        # (K, m, m)
    y_te = y[te]                                           # (K, m, B)
    if plan.h_tr_te is None:
        t = fold_eval(plan.h[te], h_te, y, y_te)
        y_dot_te = y_te - t
        y_dot_tr = None
    else:
        e_hat = hat_errors(plan.h, y)
        t = foldsolve(h_te, e_hat[te])
        y_dot_te = y_te - t
        e_dot_tr = e_hat[plan.tr_idx] + torch.bmm(plan.h_tr_te, t)
        y_dot_tr = y[plan.tr_idx] - e_dot_tr
    if squeeze:
        y_dot_te = y_dot_te[..., 0]
        y_dot_tr = None if y_dot_tr is None else y_dot_tr[..., 0]
    return y_dot_te, y_dot_tr


def binary_dvals(plan: CVPlan, y: torch.Tensor, adjust_bias: bool = True,
                 *, fused: Optional[bool] = None) -> torch.Tensor:
    """Cross-validated decision values for binary LDA (labels ±1).

    ``y`` is (N,) or (N, B) — a trailing batch dim carries permutations
    (§2.7); all B label vectors share the plan.

    With ``adjust_bias`` (paper §2.5) the regression bias b_LR is replaced
    by the LDA bias b_LDA using the cross-validated *training* decision
    values: dval ← ẏ_Te − (μ̂₁ + μ̂₂)/2 where μ̂_l is the mean training
    decision value of class l under the fold's model. This never forms w.
    """
    y = y.to(plan.h.dtype)
    squeeze = y.ndim == 1
    yb = y[:, None] if squeeze else y                          # (N, B)
    y_dot_te, y_dot_tr = cv_errors(plan, yb, fused=fused)      # (K, m, B)
    if adjust_bias:
        if y_dot_tr is None:
            raise ValueError("plan must be prepared with with_train_block=True")
        pos = (yb[plan.tr_idx] > 0).to(yb.dtype)               # (K, N-m, B)
        neg = 1.0 - pos
        mu1 = (y_dot_tr * pos).sum(dim=1) / torch.clamp(pos.sum(dim=1), min=1.0)
        mu2 = (y_dot_tr * neg).sum(dim=1) / torch.clamp(neg.sum(dim=1), min=1.0)
        # ẏ − b_LR + b_LDA = ẏ − (μ₁ + μ₂)/2  (projected-class-mean midpoint)
        y_dot_te = y_dot_te - 0.5 * (mu1 + mu2)[:, None, :]
    return y_dot_te[..., 0] if squeeze else y_dot_te


def binary_cv(x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float = 0.0,
              mode: str = "auto", adjust_bias: bool = True):
    """One-shot analytical binary-LDA cross-validation.

    Returns (dvals_te, y_te): per-fold decision values and matching labels,
    both (K, m), ready for ``metrics.binary_accuracy`` / ``metrics.auc``.
    """
    plan = prepare(x, folds, lam, mode=mode, with_train_block=adjust_bias)
    dvals = binary_dvals(plan, y, adjust_bias=adjust_bias)
    return dvals, y[folds.te_idx]


# ---------------------------------------------------------------------------
# Serving support: plan fingerprinting and evaluator factories. The plan is
# label-invariant (§2.7), so a content fingerprint of (X, folds, λ, mode)
# identifies it exactly; digests equal the reference package's for the same
# arrays, so the two packages can address the same stored plans.
# ---------------------------------------------------------------------------

_FINGERPRINT_SAMPLE_CAP = 1 << 20  # elements hashed exactly before sampling


def fingerprint(x, *, sample_cap: int = _FINGERPRINT_SAMPLE_CAP) -> str:
    """Stable content digest of a tensor or array (shape + dtype + values).

    Up to ``sample_cap`` elements are hashed exactly; larger arrays by a
    deterministic strided subsample plus a global float64 checksum. Both
    are taken on the host with numpy, exactly as the reference does: a
    device reduction sums in another order and would give other bits.
    Tensors are mutable, so digests are not memoised.
    """
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((arr.shape, str(arr.dtype))).encode())
    if arr.size <= sample_cap:
        h.update(np.ascontiguousarray(arr).tobytes())
    else:
        flat = np.ascontiguousarray(arr).reshape(-1)
        stride = -(-arr.size // sample_cap)
        h.update(np.ascontiguousarray(flat[::stride]).tobytes())
        h.update(np.float64(flat.sum(dtype=np.float64)).tobytes())
    return h.hexdigest()


def plan_key(x, folds: Folds, lam: float, mode: str = "auto",
             with_train_block: bool = True, *, version: int = 0,
             precision: Optional[str] = None) -> tuple:
    """Hashable identity of the :class:`CVPlan` that ``prepare`` would build.

    Both index tensors are fingerprinted (tr_idx is not derivable from
    te_idx in general). ``version`` is the dataset-registry version;
    ``precision`` the Gram-build precision (None → "fp32"). The last
    element stays ``with_train_block`` (the ``key[:-1] + (flag,)`` idiom).
    """
    n, p = x.shape
    if mode == "auto":
        mode = "dual" if p >= n else "primal"
    return (fingerprint(x), fingerprint(folds.te_idx),
            fingerprint(folds.tr_idx), float(lam), mode, int(version),
            check_precision(precision), bool(with_train_block))


#: Plan leaves in flattening order; ``h_tr_te`` is optional (None unless
#: the plan was prepared with train blocks).
PLAN_FIELDS = ("h", "te_idx", "tr_idx", "chol_ih", "h_tr_te")


def plan_to_arrays(plan: CVPlan) -> dict:
    """Host-side ``{leaf name: np.ndarray}`` snapshot of a plan, bit-exact;
    a None ``h_tr_te`` is omitted."""
    return {name: getattr(plan, name).detach().cpu().numpy()
            for name in PLAN_FIELDS if getattr(plan, name) is not None}


def plan_from_arrays(arrays, *, device=None) -> CVPlan:
    """Rebuild a :class:`CVPlan` from a :func:`plan_to_arrays` mapping —
    this package's or the reference's, which share the layout.

    ``device=None`` means ``cuda`` (see ``kernels.common.resolve_device``).
    A mapping missing any of the four required leaves is rejected.
    """
    missing = [n for n in PLAN_FIELDS[:4] if n not in arrays]
    if missing:
        raise ValueError(f"plan arrays missing required leaves {missing}")
    dev = resolve_device(device)

    def leaf(name):
        a = arrays.get(name)
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    return CVPlan(*(leaf(name) for name in PLAN_FIELDS))


def make_eval_binary(adjust_bias: bool = True, fused: Optional[bool] = None):
    """Evaluator ``(plan, y (N, B)) -> dvals (K, m, B)``; ``fused`` as in
    :func:`cv_errors`."""
    return lambda plan, y: binary_dvals(plan, y, adjust_bias=adjust_bias, fused=fused)


def make_eval_cv(fused: Optional[bool] = None):
    """Evaluator ``(plan, y (N, B)) -> ẏ_Te (K, m, B)`` — the ridge-regression
    serving path (Eq. 14 only, no bias adjust)."""
    return lambda plan, y: cv_errors(plan, y, fused=fused)[0]
