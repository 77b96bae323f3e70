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

The incremental update lineage (:func:`update_plan`, :func:`downdate_plan`,
:func:`sliding_window`) advances a dual-mode plan by rank-k corrections
instead of a rebuild, in float64 on the plan's device.
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

# reprolint: host-float64
# (The incremental update lineage — update_plan/downdate_plan/
# sliding_window and their helpers — matches from-scratch rebuilds only
# because every correction stays IEEE float64, per arXiv 2401.13185. RL005
# flags any sub-float64 dtype in this module.)

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
    "update_plan",
    "downdate_plan",
    "sliding_window",
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


# ---------------------------------------------------------------------------
# Incremental plan updates (streaming data): rank-k update / downdate of a
# cached dual-mode plan when rows arrive or retire, instead of a full
# rebuild. Follows the partition-incremental Gram idea of arXiv 2401.13185
# (fold-wise X^TX blocks admit exact updates with centering corrections),
# specialised to the paper's dual form:
#
#     A = G_c + λI,   S := H − 1/N·11ᵀ = G_c A⁻¹ = I − λA⁻¹
#
# so the *inverse is recoverable from the stored hat matrix* in O(N²):
# A⁻¹ = (I − S)/λ — no refactorisation needed to start an update. Appending
# k rows shifts the column means μ → μ′, which perturbs the old-row block by
# the rank-2 correction R = u1ᵀ + 1uᵀ + (δᵀδ)11ᵀ (δ = μ−μ′, u = X_cδ);
# Woodbury absorbs R, a Schur complement bolts on the k new rows, and
# H′ = I − λA′⁻¹ + 1/N′·11ᵀ. Dropping rows is the principal-submatrix
# inverse identity plus the same mean-shift correction. Total cost is
# O(N²k + NPk) per update — never O(N³) or O(N²P).
#
# The dense math runs in torch float64 on the plan's device (the reference
# runs it in host NumPy only to keep XLA from compiling per shape; eager
# PyTorch compiles nothing). ``x`` and ``x_new`` must already lie on the
# plan's device: they are never moved quietly. The fold bookkeeping is
# small integer index arrays, kept in NumPy int64 on the host as the
# reference keeps them. The cast back to the plan's dtype happens only in
# _finish_plan's return. Tolerances vs a from-scratch ``prepare`` rebuild
# are pinned at ≤1e-5 by the parity tests.
# ---------------------------------------------------------------------------


def _host_ints(a) -> np.ndarray:
    """An index array (tensor on any device, or array-like) as NumPy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _on_plan_device(name: str, a, plan: CVPlan) -> torch.Tensor:
    """``a`` itself, after checking it is a tensor on the plan's device."""
    if not isinstance(a, torch.Tensor) or a.device != plan.h.device:
        got = a.device if isinstance(a, torch.Tensor) else type(a).__name__
        raise ValueError(f"{name} must be a tensor on the plan's device "
                         f"({plan.h.device}), got {got}; move it there first")
    return a


def _resolve_update_mode(mode: str, x_shape) -> str:
    if mode == "auto":
        n, p = x_shape
        mode = "dual" if p >= n else "primal"
    if mode != "dual":
        raise ValueError(
            "incremental plan updates require a dual-mode plan (P >= N "
            "regime): the N×N hat matrix determines (G_c + λI)⁻¹ exactly, "
            "which is what the rank-k correction advances. Rebuild primal "
            "plans with prepare() instead.")
    return mode


def _dual_inverse_from_plan(plan: CVPlan, lam: float) -> torch.Tensor:
    """Recover A⁻¹ = (G_c + λI)⁻¹ from the stored dual hat matrix, O(N²)."""
    h = plan.h.to(torch.float64)
    n = h.shape[0]
    m = (torch.eye(n, dtype=h.dtype, device=h.device) - (h - 1.0 / n)) / float(lam)
    return 0.5 * (m + m.T)


def _mean_shift_inverse(m: torch.Tensor, x_c: torch.Tensor,
                        delta: torch.Tensor) -> torch.Tensor:
    """(A + R)⁻¹ from M = A⁻¹ for the centering correction R.

    R = u1ᵀ + 1uᵀ + (δᵀδ)11ᵀ with u = X_cδ — the exact perturbation of a
    centered Gram when the centering mean shifts by δ. Factor R = W K Wᵀ,
    W = [u, 1], K = [[0,1],[1,δᵀδ]] (det −1, always invertible — robust
    even at δ = 0), and apply Woodbury.
    """
    u = x_c @ delta
    w = torch.stack([u, torch.ones_like(u)], dim=1)           # (N, 2)
    k_inv = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=m.dtype, device=m.device)
    k_inv[0, 0] = -(delta @ delta)                            # K⁻¹, no host sync
    mw = m @ w                                                # (N, 2)
    core = k_inv + w.T @ mw                                   # (2, 2)
    out = m - mw @ torch.linalg.solve(core, mw.T)
    return 0.5 * (out + out.T)


def _append_inverse(m: torch.Tensor, x_old: torch.Tensor, x_new: torch.Tensor,
                    lam: float) -> torch.Tensor:
    """A′⁻¹ for [x_old; x_new] (centered at the new mean) from M = A⁻¹."""
    n, k = x_old.shape[0], x_new.shape[0]
    mu = x_old.mean(dim=0)
    mu2 = (n * mu + x_new.sum(dim=0)) / (n + k)
    # Re-center the old block at μ′ (rank-2 Woodbury), then Schur-bolt the
    # k new rows on. The old block A + R equals Z_oZ_oᵀ + λI exactly, with
    # Z_o = x_old − 1μ′ᵀ, so the assembled blocks form (G′_c + λI)⁻¹.
    m_c = _mean_shift_inverse(m, x_old - mu, mu - mu2)
    z_old = x_old - mu2
    z_new = x_new - mu2
    b = z_old @ z_new.T                                       # (N, k)
    c = z_new @ z_new.T + float(lam) * torch.eye(k, dtype=m.dtype, device=m.device)
    mb = m_c @ b                                              # (N, k)
    schur = c - b.T @ mb
    schur = 0.5 * (schur + schur.T)
    s_inv = torch.linalg.inv(schur)
    s_inv = 0.5 * (s_inv + s_inv.T)
    off = -mb @ s_inv                                         # (N, k)
    return torch.cat([torch.cat([m_c + mb @ s_inv @ mb.T, off], dim=1),
                      torch.cat([off.T, s_inv], dim=1)], dim=0)


def _downdate_inverse(m: torch.Tensor, x_old: torch.Tensor,
                      drop: np.ndarray) -> torch.Tensor:
    """A′⁻¹ for x_old minus ``drop`` rows (centered at the kept mean).

    The identity needs no λ: A_κκ already contains it."""
    n = x_old.shape[0]
    keep = torch.from_numpy(np.setdiff1d(np.arange(n), drop)).to(m.device)
    dr = torch.from_numpy(drop).to(m.device)
    # Principal-submatrix inverse: (A_κκ)⁻¹ = M_κκ − M_κd (M_dd)⁻¹ M_dκ.
    m_kd = m[keep[:, None], dr[None, :]]
    m_dd = m[dr[:, None], dr[None, :]]
    a_kk_inv = m[keep[:, None], keep[None, :]] - m_kd @ torch.linalg.solve(m_dd, m_kd.T)
    x_kept = x_old[keep]
    mu = x_old.mean(dim=0)
    return _mean_shift_inverse(a_kk_inv, x_kept - mu, mu - x_kept.mean(dim=0))


def _finish_plan(m_inv: torch.Tensor, lam: float, te: np.ndarray,
                 tr: np.ndarray, with_train_block: bool, dtype) -> CVPlan:
    """H′ = I − λA′⁻¹ + 1/N′·11ᵀ and the per-fold blocks, on m_inv's device.

    A fold whose I − H_Te is not positive definite raises (torch's
    ``LinAlgError``), as the reference's NumPy Cholesky does; ``prepare``
    gives such a fold a NaN factor instead.
    """
    n = m_inv.shape[0]
    dev = m_inv.device
    h = torch.eye(n, dtype=m_inv.dtype, device=dev) - float(lam) * m_inv + 1.0 / n
    h = 0.5 * (h + h.T)
    te_t = torch.from_numpy(te).to(dev)
    tr_t = torch.from_numpy(tr).to(dev)
    h_te = h[te_t[:, :, None], te_t[:, None, :]]              # (K, m, m)
    eye_m = torch.eye(te.shape[1], dtype=h.dtype, device=dev)
    chol = torch.linalg.cholesky(eye_m - h_te)
    h_tr_te = h[tr_t[:, :, None], te_t[:, None, :]] if with_train_block else None
    return CVPlan(
        h=h.to(dtype),
        te_idx=te_t.to(torch.int32),
        tr_idx=tr_t.to(torch.int32),
        chol_ih=chol.to(dtype),
        h_tr_te=None if h_tr_te is None else h_tr_te.to(dtype),
    )


def _complement_folds(te: np.ndarray, n: int) -> np.ndarray:
    """Training side = ascending complement of each fold's test set."""
    k, m = te.shape
    tr = np.empty((k, n - m), dtype=np.int64)
    for i in range(k):
        mask = np.ones(n, dtype=bool)
        mask[te[i]] = False
        tr[i] = np.nonzero(mask)[0]
    return tr


def _check_complement(te: np.ndarray, tr: np.ndarray, n: int) -> None:
    for i in range(te.shape[0]):
        mask = np.ones(n, dtype=bool)
        mask[te[i]] = False
        if not np.array_equal(np.sort(tr[i]), np.nonzero(mask)[0]):
            raise ValueError(
                "incremental fold derivation assumes complement training "
                "sets (every non-test sample trains, as all built-in fold "
                "generators produce); pass folds_delta as a full Folds for "
                "custom schemes")


def _extend_folds(te: np.ndarray, n: int, assign: np.ndarray) -> np.ndarray:
    """New te after appending rows with per-row fold assignment.

    ``assign[j]`` is the fold of appended row j (new sample id n+j), or −1
    for a train-only row (the leftover convention of :mod:`repro_torch.core.folds`
    when K does not divide N). Per-fold counts must stay rectangular.
    """
    k = te.shape[0]
    if assign.ndim != 1:
        raise ValueError("folds_delta assignment must be 1-D (one fold id "
                         "per appended row)")
    if assign.size and (assign.min() < -1 or assign.max() >= k):
        raise ValueError(
            f"fold assignment out of range: got values in "
            f"[{assign.min()}, {assign.max()}], plan has {k} folds")
    tested = assign[assign >= 0]
    counts = np.bincount(tested, minlength=k)
    if counts.max() != counts.min():
        raise ValueError(
            "appending would make per-fold test sizes ragged "
            f"(counts per fold {counts.tolist()}); static shapes require "
            "equal fold sizes — assign equally many rows to every fold "
            "(or -1 for train-only rows)")
    new_ids = n + np.arange(assign.size)
    return np.stack(
        [np.concatenate([te[f], new_ids[assign == f]]) for f in range(k)])


def _drop_folds(te: np.ndarray, n: int, drop: np.ndarray) -> np.ndarray:
    """New te (renumbered over the kept rows) after dropping ``drop``."""
    keep_mask = np.ones(n, dtype=bool)
    keep_mask[drop] = False
    remap = np.cumsum(keep_mask) - 1
    rows = [remap[row[keep_mask[row]]] for row in te]
    sizes = {len(r) for r in rows}
    if len(sizes) != 1:
        raise ValueError(
            "dropping those rows would make per-fold test sizes ragged "
            f"(sizes {sorted(len(r) for r in rows)}); drop equally many "
            "test samples from every fold, or use sliding_window to "
            "backfill the slots with appended rows")
    return np.stack(rows).astype(np.int64)


def _window_folds(te: np.ndarray, n: int, drop: np.ndarray,
                  assign: np.ndarray) -> np.ndarray:
    """New te for drop+append in one move, ragged-checked only at the end.

    Unbalanced drops are fine here (unlike :func:`_drop_folds`) as long as
    the appended rows backfill the holes to equal per-fold sizes. Kept rows
    are renumbered by rank among survivors; appended row j becomes sample
    ``n - len(drop) + j``.
    """
    k_new = assign.size
    rows = []
    for f in range(te.shape[0]):
        kept = te[f][~np.isin(te[f], drop)]
        add = n + np.nonzero(assign == f)[0]
        rows.append(np.concatenate([kept, add]))
    sizes = {len(r) for r in rows}
    if len(sizes) != 1:
        raise ValueError(
            "window advance would make per-fold test sizes ragged "
            f"(sizes {sorted(len(r) for r in rows)}); appended rows must "
            "backfill dropped test slots to equal per-fold counts")
    keep = np.setdiff1d(np.arange(n), drop)
    remap = np.full(n + k_new, -1, dtype=np.int64)
    remap[keep] = np.arange(keep.size)
    remap[n:] = keep.size + np.arange(k_new)
    return np.stack([remap[r] for r in rows]).astype(np.int64)


def _fold_of(te: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Fold membership of each sample id in ``idx`` (−1 if train-only)."""
    out = np.full(idx.shape, -1, dtype=np.int64)
    for f in range(te.shape[0]):
        out[np.isin(idx, te[f])] = f
    return out


def _validate_drop(drop, n: int) -> np.ndarray:
    drop = _host_ints(drop)
    if drop.ndim != 1 or drop.size == 0:
        raise ValueError("drop_idx must be a non-empty 1-D index array")
    if not np.issubdtype(drop.dtype, np.integer):
        raise ValueError(f"drop_idx must be integer, got dtype {drop.dtype}")
    drop = drop.astype(np.int64)
    if drop.min() < 0 or drop.max() >= n:
        raise ValueError(f"drop_idx out of range for N={n}")
    if np.unique(drop).size != drop.size:
        raise ValueError("drop_idx contains duplicate rows")
    if drop.size >= n:
        raise ValueError("cannot drop every row of the dataset")
    return drop


def _update_inputs(plan: CVPlan, x, lam: float, mode: str):
    """Shared validation; returns (x in float64, te, tr, with_train_block,
    the plan's dtype)."""
    x = _on_plan_device("x", x, plan)
    if x.ndim != 2:
        raise ValueError("x must be the 2-D feature matrix the plan was "
                         "built from")
    n = plan.h.shape[0]
    if x.shape[0] != n:
        raise ValueError(
            f"x has {x.shape[0]} rows but the plan was built over {n} "
            "samples — pass the exact feature matrix behind this plan")
    if not isinstance(lam, (int, float)) or float(lam) <= 0.0:
        raise ValueError("incremental updates require a concrete lam > 0 "
                         "(the dual-mode operating point)")
    _resolve_update_mode(mode, tuple(x.shape))
    te = _host_ints(plan.te_idx).astype(np.int64)
    tr = _host_ints(plan.tr_idx).astype(np.int64)
    _check_complement(te, tr, n)
    return x.to(torch.float64), te, tr, plan.h_tr_te is not None, plan.h.dtype


def _new_rows(x_new, plan: CVPlan, p: int) -> torch.Tensor:
    xn = _on_plan_device("x_new", x_new, plan)
    if xn.ndim != 2 or xn.shape[1] != p:
        raise ValueError(
            f"x_new must be (k, {p}) to match the dataset, got "
            f"shape {tuple(xn.shape)}")
    return xn.to(torch.float64)


def _coerce_folds_delta(folds_delta, k_new: int):
    """folds_delta is a full Folds (custom schemes) or a per-row assignment."""
    if isinstance(folds_delta, Folds):
        return folds_delta
    assign = _host_ints(folds_delta)
    if not np.issubdtype(assign.dtype, np.integer):
        raise ValueError("per-row fold assignment must be integer "
                         f"(got dtype {assign.dtype})")
    assign = assign.astype(np.int64).reshape(-1)
    if assign.size != k_new:
        raise ValueError(
            f"fold assignment has {assign.size} entries for "
            f"{k_new} appended rows")
    return assign


def _folds_of(delta: Folds):
    return (_host_ints(delta.te_idx).astype(np.int64),
            _host_ints(delta.tr_idx).astype(np.int64))


def update_plan(plan: CVPlan, x_new, folds_delta, *, x, lam: float,
                mode: str = "dual") -> CVPlan:
    """Advance a dual-mode plan by appending rows — a rank-k correction.

    Args:
      plan: the cached plan for ``x`` (dual mode, built by :func:`prepare`
        or a previous update).
      x_new: (k, P) appended feature rows, a tensor on the plan's device;
        the updated dataset is ``torch.cat([x, x_new])`` in that order.
      folds_delta: either a per-appended-row fold assignment (1-D int array,
        −1 = train-only leftover) or a full :class:`Folds` over N+k samples
        for custom schemes.
      x: the (N, P) feature matrix the plan was built from, a tensor on the
        plan's device (keyword-only — the plan itself stores only N×N
        objects).
      lam: the plan's ridge strength (> 0).
      mode: must resolve to "dual"; primal plans cannot be advanced.

    Returns a new :class:`CVPlan` over N+k samples on the plan's device,
    equal to ``prepare(torch.cat([x, x_new]), new_folds, lam, "dual")`` to
    ≤1e-5 without rebuilding the Gram. Cost O(N²k + NPk).
    """
    x64, te, tr, wtb, dtype = _update_inputs(plan, x, lam, mode)
    n = x64.shape[0]
    xn = _new_rows(x_new, plan, x64.shape[1])
    if folds_delta is None:
        raise ValueError("update_plan needs folds_delta: a fold id per "
                         "appended row (-1 = train-only) or a full Folds")
    delta = _coerce_folds_delta(folds_delta, xn.shape[0])
    if isinstance(delta, Folds):
        te2, tr2 = _folds_of(delta)
    else:
        te2 = _extend_folds(te, n, delta)
        tr2 = _complement_folds(te2, n + xn.shape[0])
    m = _dual_inverse_from_plan(plan, lam)
    m2 = _append_inverse(m, x64, xn, lam)
    return _finish_plan(m2, lam, te2, tr2, wtb, dtype)


def downdate_plan(plan: CVPlan, drop_idx, *, x, lam: float,
                  mode: str = "dual") -> CVPlan:
    """Retire rows from a dual-mode plan — the inverse rank-k correction.

    ``drop_idx`` indexes rows of ``x``; surviving rows keep their relative
    order and are renumbered densely (new id = old rank among kept rows),
    so the updated dataset is ``x[keep]`` with ``keep`` sorted. Per-fold
    test sizes must stay rectangular after the drop (drop equally many test
    samples per fold, or train-only rows); use :func:`sliding_window` to
    backfill slots instead. Cost O(N²d + d³).
    """
    x64, te, tr, wtb, dtype = _update_inputs(plan, x, lam, mode)
    n = x64.shape[0]
    drop = _validate_drop(drop_idx, n)
    te2 = _drop_folds(te, n, drop)
    tr2 = _complement_folds(te2, n - drop.size)
    m = _dual_inverse_from_plan(plan, lam)
    m2 = _downdate_inverse(m, x64, drop)
    return _finish_plan(m2, lam, te2, tr2, wtb, dtype)


def sliding_window(plan: CVPlan, x_new, drop_idx, *, x, lam: float,
                   mode: str = "dual", folds_delta=None) -> CVPlan:
    """Append + drop in one correction — the streaming steady state.

    The window advances: ``drop_idx`` rows retire and ``x_new`` rows arrive,
    with N (and therefore every downstream eval shape) unchanged whenever
    ``len(x_new) == len(drop_idx)``. By default each appended row inherits
    the fold slot of a dropped row (matched in sorted drop order), so the
    fold geometry is preserved exactly; pass ``folds_delta`` to re-assign
    instead. The updated dataset is ``torch.cat([x[keep], x_new])``.
    """
    x64, te, tr, wtb, dtype = _update_inputs(plan, x, lam, mode)
    n = x64.shape[0]
    drop = _validate_drop(drop_idx, n)
    xn = _new_rows(x_new, plan, x64.shape[1])
    n_kept = n - drop.size
    if folds_delta is None:
        if xn.shape[0] != drop.size:
            raise ValueError(
                "sliding_window without folds_delta requires "
                "len(x_new) == len(drop_idx) so appended rows can inherit "
                f"the dropped rows' fold slots (got {xn.shape[0]} new vs "
                f"{drop.size} dropped)")
        assign = _fold_of(te, np.sort(drop))
        te2 = _window_folds(te, n, drop, assign)
        tr2 = _complement_folds(te2, n_kept + xn.shape[0])
    else:
        delta = _coerce_folds_delta(folds_delta, xn.shape[0])
        if isinstance(delta, Folds):
            te2, tr2 = _folds_of(delta)
        else:
            te2 = _window_folds(te, n, drop, delta)
            tr2 = _complement_folds(te2, n_kept + xn.shape[0])
    m = _dual_inverse_from_plan(plan, lam)
    m_dropped = _downdate_inverse(m, x64, drop)
    keep = torch.from_numpy(np.setdiff1d(np.arange(n), drop)).to(x64.device)
    m2 = _append_inverse(m_dropped, x64[keep], xn, lam)
    return _finish_plan(m2, lam, te2, tr2, wtb, dtype)
