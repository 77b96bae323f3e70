"""repro_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason.
On a machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda
--noconftest tests/test_torch_cuda.py`` (the first test builds the kernels
with nvcc; ``--noconftest`` skips the root conftest, which configures jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import fastcv, folds, multiclass
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fold_eval.fold_eval import fold_eval_cuda
from repro_torch.kernels.fold_eval.ops import fold_eval
from repro_torch.kernels.fold_eval.ref import fold_eval_checked_ref, fold_eval_ref
from repro_torch.kernels.foldsolve.foldsolve import foldsolve_cuda
from repro_torch.kernels.foldsolve.ops import fold_jitter, fold_residual_bad, foldsolve
from repro_torch.kernels.foldsolve.ref import foldsolve_checked_ref, foldsolve_ref
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.gram.ref import gram_ref
from repro_torch.kernels.hat_apply.ops import hat_errors
from repro_torch.kernels.hat_apply.ref import hat_apply_ref
from repro_torch.kernels.pairdist.ops import pairwise_sq_dists
from repro_torch.kernels.pairdist.pairdist import S_MAX_C, S_THRESHOLD, pairdist_cuda
from repro_torch.kernels.pairdist.ref import pairwise_sq_dists_ref
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.rsa import rdm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-9}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.abs().max().clamp(min=1e-30))
    assert float((got - want).abs().max()) <= tol * scale


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] > before
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", [(8, 16), (130, 1037), (200, 5000)])
def test_gram_kernel(gen, dtype, n, p):
    x = torch.randn(n, p, generator=gen, device="cuda", dtype=dtype)
    _close(_launched("gram", lambda: gram(x)), gram_ref(x), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(16, 1), (131, 70), (300, 250)])
def test_hat_apply_kernel(gen, dtype, n, b):
    h = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype) / n
    y = torch.randn(n, b, generator=gen, device="cuda", dtype=dtype)
    _close(_launched("hat_apply", lambda: hat_errors(h, y)), hat_apply_ref(h, y), TOL[dtype])


# The f32 and bf16 routes of gram and the f32 route of hat_apply run on the
# tensor cores (TF32 products of a big + small split for f32): within the f32
# pin of the plain version and of the f64 product, G exactly symmetric, and
# both bitwise equal across calls (fixed sum orders, no atomics).
@pytest.mark.parametrize("n,p", [(130, 1037), (787, 76000)])
def test_gram_tensor_core_route_is_symmetric_and_repeatable(gen, n, p):
    x = torch.randn(n, p, generator=gen, device="cuda")
    got = _launched("gram", lambda: gram(x))
    assert torch.equal(got, got.T) and torch.equal(got, gram(x))
    _close(got, gram_ref(x), TOL[torch.float32])
    _close(got.double(), gram_ref(x.double()), TOL[torch.float32])


@pytest.mark.parametrize("n,p", [(8, 16), (130, 1037), (787, 5000)])
def test_bf16_gram_kernel(gen, n, p):
    x = torch.randn(n, p, generator=gen, device="cuda")
    got = _launched("gram", lambda: gram(x, precision="bf16_gram"))
    assert got.dtype == torch.float32 and torch.equal(got, got.T)
    _close(got, gram_ref(x.to(torch.bfloat16)), TOL[torch.float32])


@pytest.mark.parametrize("b", [1, 3, 64, 250])
@pytest.mark.parametrize("n", [16, 131, 787])
def test_hat_apply_tensor_core_route(gen, n, b):
    h = torch.randn(n, n, generator=gen, device="cuda") / n
    y = torch.randn(n, b, generator=gen, device="cuda")
    got = _launched("hat_apply", lambda: hat_errors(h, y))
    assert torch.equal(got, hat_errors(h, y))
    _close(got, hat_apply_ref(h, y), TOL[torch.float32])
    _close(got.double(), hat_apply_ref(h.double(), y.double()), TOL[torch.float32])


def test_hat_apply_tensor_core_route_refuses_unaligned_data(gen):
    """The f32 route copies H and Y in aligned 16-byte pieces: a view that
    starts 4 bytes into its storage is refused before the launch."""
    h = torch.randn(17, 17, generator=gen, device="cuda")
    y = torch.randn(18, 2, generator=gen, device="cuda").flatten()[1:35].view(17, 2)
    before = _build.LAUNCHES["hat_apply"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        hat_errors(h, y)
    assert _build.LAUNCHES["hat_apply"] == before


# The f64 routes run on the FP64 tensor cores (DMMA): within 1e-9 of the
# plain version, G exactly symmetric, both bitwise equal across calls, at
# every split rule's regime (one split: hat_apply's Y − H·Y written by the
# first pass), odd P and B = 1, and on views that start at an odd f64 offset
# (8 bytes past a 16-byte boundary: the 8-byte copies).
def _at_offset(gen, shape, offset):
    numel = shape[0] * shape[1]
    flat = torch.randn(numel + offset, generator=gen, device="cuda", dtype=torch.float64)
    return flat[offset:].view(shape)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,p", [(8, 16), (130, 1037), (130, 1030), (384, 2304),
                                 (787, 76000)])
def test_gram_f64_tensor_core_route(gen, n, p, offset):
    x = _at_offset(gen, (n, p), offset)
    assert x.data_ptr() % 16 == 8 * offset
    got = _launched("gram", lambda: gram(x))
    assert torch.equal(got, got.T) and torch.equal(got, gram(x))
    _close(got, gram_ref(x), TOL[torch.float64])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,b", [(16, 1), (131, 70), (384, 64), (787, 1), (787, 250)])
def test_hat_apply_f64_tensor_core_route(gen, n, b, offset):
    h = _at_offset(gen, (n, n), offset) / n
    y = _at_offset(gen, (n, b), offset)
    got = _launched("hat_apply", lambda: hat_errors(h, y))
    assert torch.equal(got, hat_errors(h, y))
    _close(got, hat_apply_ref(h, y), TOL[torch.float64])


@pytest.mark.parametrize("dtype,tol,offset", [(torch.float32, 1e-4, 0),
                                              (torch.float64, 1e-9, 8)])
def test_binary_dvals_of_a_label_row_on_the_card(gen, monkeypatch, dtype, tol, offset):
    """A label vector that is a row of a (T, N) tensor starts N·itemsize
    bytes into its storage (12 mod 16 in f32, 8 in f64 at N = 787): the
    kernel route takes it and equals the CPU route. f32 labels reach
    hat_apply as an aligned copy, f64 labels as they are (the 8-byte
    copies). (f32: the card's and the CPU's hat matrices round
    differently, ~1e-6 of scale.)"""
    n = 787
    x = torch.randn(n, 40, generator=gen, device="cuda", dtype=torch.float64).to(dtype)
    ys = torch.where(torch.rand(3, n, generator=gen, device="cuda") < 0.5, 1.0, -1.0).to(dtype)
    assert ys[1].data_ptr() % 16 == (n * ys.element_size()) % 16 != 0
    plan = fastcv.prepare(x, folds.kfold(n, 10, device="cuda"), 2.0)
    plan_cpu = fastcv.prepare(x.cpu(), folds.kfold(n, 10, device="cpu"), 2.0)
    seen = []
    hat_errors_ = fastcv.hat_errors

    def recording(h, y):
        seen.append(y.data_ptr() % 16)
        return hat_errors_(h, y)

    monkeypatch.setattr(fastcv, "hat_errors", recording)
    got = _launched("hat_apply", lambda: fastcv.binary_dvals(plan, ys[1]))
    assert seen == [offset]
    monkeypatch.undo()
    _close(got.cpu(), fastcv.binary_dvals(plan_cpu, ys[1].cpu()), tol)


def _h_te(gen, k, m, dtype):
    a = torch.randn(k, m, m, generator=gen, device="cuda", dtype=dtype) / (3 * m ** 0.5)
    return -(a @ a.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,m,b", [(40, 1, 3), (787, 1, 1), (10, 78, 250), (3, 17, 70),
                                   (2, 230, 5)])
def test_foldsolve_kernel(gen, dtype, k, m, b):
    h_te = _h_te(gen, k, m, dtype)
    e = torch.randn(k, m, b, generator=gen, device="cuda", dtype=dtype)
    got = _launched("foldsolve", lambda: foldsolve(h_te, e, jitter=None))
    _close(got, foldsolve_ref(h_te, e), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,m,n,b", [(10, 78, 787, 1), (787, 1, 787, 1), (3, 17, 131, 70),
                                     (2, 230, 460, 3)])
def test_fold_eval_kernel(gen, dtype, k, m, n, b):
    h_rows = torch.randn(k, m, n, generator=gen, device="cuda", dtype=dtype) / n
    h_te = _h_te(gen, k, m, dtype)
    y = torch.randn(n, b, generator=gen, device="cuda", dtype=dtype)
    y_te = torch.randn(k, m, b, generator=gen, device="cuda", dtype=dtype)
    got = _launched("fold_eval", lambda: fold_eval(h_rows, h_te, y, y_te, jitter=None))
    _close(got, fold_eval_ref(h_rows, h_te, y, y_te)[0], TOL[dtype])


def test_jitter_retry_on_the_card(gen):
    m = 12
    q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen, device="cuda",
                                       dtype=torch.float64))
    d = torch.ones(m, device="cuda", dtype=torch.float64)
    d[-1] = 1e-14
    eye = torch.eye(m, device="cuda", dtype=torch.float64)
    h_te = (eye - (q * d) @ q.T).expand(3, m, m).contiguous()
    e = torch.randn(3, m, 4, generator=gen, device="cuda", dtype=torch.float64)
    got = foldsolve(h_te, e)
    want = torch.linalg.solve(eye - h_te + fold_jitter(h_te)[:, None, None] * eye, e)
    _close(got, want, 1e-8)


def _mixed_folds(gen, k, m, b, dtype):
    """k folds with I − H_Te SPD, and fold 1 near-singular: Q·diag(1, …, d)·Qᵀ
    for m ≥ 2 (d = 1e-14 in f64, 0 before the f32 rounding), its first 64
    right-hand sides off the near-null direction (so that in f64 only its
    later tiles fail the check); H = 1, a zero pivot, for m = 1."""
    h_te = _h_te(gen, k, m, dtype)
    e = torch.randn(k, m, b, generator=gen, device="cuda", dtype=torch.float64)
    if m == 1:
        h_te[1] = 1.0
    else:
        q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen, device="cuda",
                                           dtype=torch.float64))
        d = torch.ones(m, device="cuda", dtype=torch.float64)
        d[-1] = 1e-14 if dtype == torch.float64 else 0.0
        eye = torch.eye(m, device="cuda", dtype=torch.float64)
        h_te[1] = (eye - (q * d) @ q.T).to(dtype)
        null = q[:, -1]
        e[1, :, :64] -= torch.outer(null, null @ e[1, :, :64])
    return h_te, e.to(dtype)


_CHECKED_CASES = [(3, 12, 250), (40, 1, 64), (3, 17, 250), (3, 78, 250), (3, 230, 250),
                  (2, 393, 250)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,m,b", _CHECKED_CASES)
def test_foldsolve_checked_kernel(gen, dtype, k, m, b):
    """One launch with the check against the plain checked solve: the
    near-singular fold is solved again whole, the healthy folds keep the
    raw solve bit for bit, and the kernel's bad flags are its raw solve's."""
    h_te, e = _mixed_folds(gen, k, m, b, dtype)
    raw = foldsolve(h_te, e, jitter=None)
    want_bad = fold_residual_bad(h_te, raw, e)
    assert want_bad.tolist() == [i == 1 for i in range(k)]
    before = _build.LAUNCHES["foldsolve"]
    got, bad = foldsolve_cuda(h_te, e, check=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["foldsolve"] == before + 1
    assert torch.equal(bad, want_bad)
    _close(got, foldsolve_checked_ref(h_te, e), TOL[dtype])
    healthy = ~want_bad
    assert torch.equal(got[healthy], raw[healthy])
    assert not torch.equal(got[1, :, :64], raw[1, :, :64])
    assert torch.equal(foldsolve(h_te, e), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,m,b", _CHECKED_CASES)
def test_fold_eval_checked_kernel(gen, dtype, k, m, b):
    """fold_eval's one launch against its plain checked version, on the same
    folds; ê comes from the kernel's own contraction."""
    h_te, e = _mixed_folds(gen, k, m, b, dtype)
    n = 2 * m + 31
    h_rows = torch.randn(k, m, n, generator=gen, device="cuda", dtype=dtype) / n
    y = torch.randn(n, b, generator=gen, device="cuda", dtype=dtype)
    y_te = (e + h_rows @ y).contiguous()
    raw, e_hat, no_flags = fold_eval_cuda(h_rows, h_te, y, y_te, check=False)
    assert no_flags is None
    want_bad = fold_residual_bad(h_te, raw, e_hat)
    assert want_bad.tolist() == [i == 1 for i in range(k)]
    before = _build.LAUNCHES["fold_eval"]
    got, e_got, bad = fold_eval_cuda(h_rows, h_te, y, y_te, check=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fold_eval"] == before + 1
    assert torch.equal(bad, want_bad) and torch.equal(e_got, e_hat)
    _close(got, fold_eval_checked_ref(h_rows, h_te, y, y_te), TOL[dtype])
    healthy = ~want_bad
    assert torch.equal(got[healthy], raw[healthy])
    assert torch.equal(fold_eval(h_rows, h_te, y, y_te), got)


@pytest.mark.parametrize("kernel", ["foldsolve", "fold_eval"])
@pytest.mark.parametrize("near_singular", [False, True])
def test_one_launch_per_call(gen, kernel, near_singular):
    """Each call of the wrappers is one launch, with or without a fold to
    retry, and with the check on or off."""
    k, m, b = 10, 78, 250
    if near_singular:
        h_te, e = _mixed_folds(gen, k, m, b, torch.float64)
    else:
        h_te = _h_te(gen, k, m, torch.float64)
        e = torch.randn(k, m, b, generator=gen, device="cuda", dtype=torch.float64)
    h_rows = torch.randn(k, m, 300, generator=gen, device="cuda", dtype=torch.float64) / 300
    y = torch.randn(300, b, generator=gen, device="cuda", dtype=torch.float64)
    for jitter in ("auto", None, "auto"):
        before = _build.LAUNCHES[kernel]
        if kernel == "foldsolve":
            foldsolve(h_te, e, jitter=jitter)
        else:
            fold_eval(h_rows, h_te, y, e, jitter=jitter)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kernel] == before + 1


def test_binary_cv_on_the_card_equals_the_cpu(gen):
    x = torch.randn(60, 300, generator=gen, device="cuda", dtype=torch.float64)
    y = torch.where(torch.arange(60, device="cuda") % 2 == 0, 1.0, -1.0).double()
    gpu = fastcv.binary_cv(x, y, folds.kfold(60, 5, device="cuda"), 50.0)[0]
    cpu = fastcv.binary_cv(x.cpu(), y.cpu(), folds.kfold(60, 5, device="cpu"), 50.0)[0]
    _close(gpu.cpu(), cpu, 1e-9)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
def test_primal_plan_dvals_through_the_kernels(gen, dtype, tol):
    """P = 380 < N = 787, the multidim path's per-point features: prepare
    builds the primal hat matrix (a matmul's output, not symmetrised), which
    hat_apply and foldsolve take as it is; the kernel route equals the
    Cholesky composite on the same plan. (f32: Gauss–Jordan against
    Cholesky, ~1e-6 of scale.)"""
    n, p = 787, 380
    x = torch.randn(n, p, generator=gen, device="cuda", dtype=dtype)
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1.0, -1.0).to(dtype)
    plan = fastcv.prepare(x, folds.kfold(n, 10, device="cuda"), 300.0)
    assert plan.h.is_contiguous() and plan.h.data_ptr() % 16 == 0
    got = _launched("foldsolve", lambda: _launched(
        "hat_apply", lambda: fastcv.binary_dvals(plan, y)))
    _close(got, fastcv.binary_dvals(plan, y, fused=False), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_update_plan_on_the_card(gen, dtype):
    """update_plan advances a plan on the card (float64 math there, no
    kernel launch) to its rebuild within the reference's 1e-5; the kernel
    route's decision values on both plans agree as closely. λ = tr(G_c)/N.
    Rows on another device than the plan's are refused."""
    n, k, p = 200, 10, 3000
    x = torch.randn(n + k, p, generator=gen, device="cuda", dtype=dtype)
    xc = x[:n] - x[:n].mean(dim=0)
    lam = float((xc * xc).sum()) / n
    plan = fastcv.prepare(x[:n], folds.kfold(n, k, device="cuda"), lam)
    before = dict(_build.LAUNCHES)
    upd = fastcv.update_plan(plan, x[n:], torch.arange(k), x=x[:n], lam=lam)
    assert _build.LAUNCHES == before and upd.h.device == x.device and upd.h.dtype == dtype
    rebuilt = fastcv.prepare(x, folds.Folds.with_indices(upd.te_idx, upd.tr_idx), lam)
    for name in ("h", "chol_ih", "h_tr_te"):
        _close(getattr(upd, name), getattr(rebuilt, name), 1e-5)
    y = torch.where(torch.arange(n + k, device="cuda") % 2 == 0, 1.0, -1.0).to(dtype)
    _close(fastcv.binary_dvals(upd, y), fastcv.binary_dvals(rebuilt, y), 1e-5)
    with pytest.raises(ValueError, match="x_new must be a tensor on the plan's device"):
        fastcv.update_plan(plan, x[n:].cpu(), torch.arange(k), x=x[:n], lam=lam)


def _pairdist_held(u, route):
    """One route (None: the rule's) against the plain version (of the f32
    cast, for bf16): ≤ 1e-5 / 1e-9 of max |D|, exactly symmetric, an
    exactly zero diagonal, bitwise repeatable."""
    call = (lambda: pairwise_sq_dists(u)) if route is None else (
        lambda: pairdist_cuda(u, route=route))
    got = _launched("pairdist", call)
    want = pairwise_sq_dists_ref(u)
    assert got.dtype == (torch.float32 if u.dtype == torch.bfloat16 else u.dtype)
    _close(got, want, TOL[got.dtype])
    assert bool((got >= 0).all()) and torch.equal(got, got.T)
    assert torch.equal(torch.diagonal(got), torch.zeros(u.shape[0], device="cuda",
                                                        dtype=got.dtype))
    assert torch.equal(got, call())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("c,p,route", [
    (2, 7, None), (5, 30, None), (8, 76000, None), (33, 500, None), (130, 1037, None),
    (200, 5000, None),
    # both routes on either side of the rule's threshold
    (S_THRESHOLD, 2048, "S"), (S_THRESHOLD, 2048, "T"),
    (S_THRESHOLD + 1, 2048, "S"), (S_THRESHOLD + 1, 2048, "T"),
    (8, 76000, "T"), (S_MAX_C, 3001, "S"),
    (787, 2048, "T"),                      # a trial-level RDM's width, short P
    (8, 1037, "S"), (13, 30001, "S"),      # P not a multiple of 4: narrow loads
])
def test_pairdist_kernel(gen, dtype, c, p, route):
    """(A single pattern has only the diagonal, where the plain version's
    rounding is all of its max |D|: that case is checked on its own.)"""
    u = torch.randn(c, p, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    _pairdist_held(u, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("route", ["S", "T"])
def test_pairdist_kernel_reads_rows_that_start_unaligned(gen, dtype, route):
    """U one element past a 16-byte boundary: route S copies element by
    element, route T its tensor-core pass's narrow pieces."""
    base = torch.randn(40 * 1000 + 1, generator=gen, device="cuda").to(dtype)
    _pairdist_held(base[1:].view(40, 1000), route)


def test_pairdist_kernel_refuses_what_a_route_does_not_take(gen):
    u = torch.zeros(S_MAX_C + 1, 64, device="cuda")
    with pytest.raises(ValueError, match="route S takes"):
        pairdist_cuda(u, route="S")
    with pytest.raises(ValueError, match="route must be"):
        pairdist_cuda(u, route="X")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_pairdist_kernel_single_pattern_is_exactly_zero(gen, dtype):
    u = torch.randn(1, 7, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    got = _launched("pairdist", lambda: pairwise_sq_dists(u))
    assert got.shape == (1, 1) and float(got) == 0.0


def test_pairdist_kernel_refuses_other_dtypes(gen):
    with pytest.raises(TypeError, match="unsupported dtype"):
        pairwise_sq_dists(torch.zeros(3, 4, device="cuda", dtype=torch.float16))


def _multiclass_problem(gen, n=90, p=400, c=3):
    y = torch.arange(n, device="cuda") % c
    means = torch.randn(c, p, generator=gen, device="cuda", dtype=torch.float64)
    x = torch.randn(n, p, generator=gen, device="cuda", dtype=torch.float64) + 0.3 * means[y]
    return x, y


def test_multiclass_cv_on_the_card_equals_the_cpu(gen):
    x, y = _multiclass_problem(gen)
    f_gpu = folds.stratified_kfold(y, 5, seed=0, device="cuda")
    f_cpu = folds.stratified_kfold(y, 5, seed=0, device="cpu")
    gpu, _ = multiclass.analytical_cv_multiclass(x, y, f_gpu, 3, 50.0)
    cpu, _ = multiclass.analytical_cv_multiclass(x.cpu(), y.cpu(), f_cpu, 3, 50.0)
    assert torch.equal(gpu.cpu(), cpu)
    std, _ = multiclass.standard_cv_multiclass(x, y, f_gpu, 3, 50.0)
    assert torch.equal(gpu, std)


def test_rdm_binary_on_the_card_equals_the_cpu(gen):
    x, y = _multiclass_problem(gen, n=96, c=6)
    f_gpu = folds.stratified_kfold(y, 4, seed=0, device="cuda")
    f_cpu = folds.stratified_kfold(y, 4, seed=0, device="cpu")
    for dissimilarity in ("accuracy", "contrast"):
        gpu = rdm.rdm_binary(x, y, f_gpu, 6, 50.0, dissimilarity=dissimilarity)
        cpu = rdm.rdm_binary(x.cpu(), y.cpu(), f_cpu, 6, 50.0, dissimilarity=dissimilarity)
        _close(gpu.cpu(), cpu, 1e-9)
    before = _build.LAUNCHES["fold_eval"]
    gpu = rdm.rdm_binary(x, y, f_gpu, 6, 50.0, adjust_bias=False)
    assert _build.LAUNCHES["fold_eval"] > before
    _close(gpu.cpu(), rdm.rdm_binary(x.cpu(), y.cpu(), f_cpu, 6, 50.0, adjust_bias=False), 1e-9)


# ----------------------------------------------------- flash attention ----
# f32: ≤ 2e-5 of max |out| (the same f32 softmax, summed in another order);
# bf16 I/O: within 2 bf16 ulps of each element (both round an f32 result
# once; a ~1e-7 difference before rounding can move it by one ulp), the ulp
# taken at no less than 2^-8 of max |out|: smaller outputs come from
# cancellation, where that f32 difference is several of their own ulps.

def _bf16_ulps(got, want):
    got, want = got.double(), want.double()
    mag = want.abs().clamp(min=float(want.abs().max()) / 256)
    return float(((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _attn_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 2.0
    else:
        _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,window,softcap", [(200, None, None), (1000, 64, 50.0),
                                              (130, 7, None), (64, None, 20.0)])
def test_flash_attention_kernel(gen, dtype, d, s, window, softcap):
    q = torch.randn(2, 8, s, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(2, 4, s, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap)
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, **kw))
    _attn_close(got, attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (6, 1)])
def test_flash_attention_kernel_gqa_and_non_causal(gen, hq, hkv):
    q = torch.randn(1, hq, 300, 128, generator=gen, device="cuda")
    k, v = (torch.randn(1, hkv, 300, 128, generator=gen, device="cuda") for _ in range(2))
    for causal in (True, False):
        got = _launched("flash_attention",
                        lambda: flash_attention(q, k, v, scale=0.1, causal=causal))
        _attn_close(got, attention_ref(q, k, v, scale=0.1, causal=causal))


# The MoE and hybrid trunks' shapes, as (B, S, H, D) views: olmoe's MHA (16 /
# 16 heads of 128), qwen3-moe's GQA (32 / 4 of 128), recurrentgemma's MQA (a
# group of 10 query heads on 1 KV head of 256, window 2,048 < S) and that
# group of 10 at D = 128; both routes, one launch each.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d,s,window", [(16, 16, 128, 600, None), (32, 4, 128, 600, None),
                                               (10, 1, 256, 2100, 2048), (10, 1, 128, 777, 100)])
def test_flash_attention_kernel_at_the_moe_and_hybrid_shapes(gen, dtype, hq, hkv, d, s, window):
    q, k, v = (torch.randn(2, s, h, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
               for h in (hq, hkv, hkv))
    kw = dict(scale=d ** -0.5, window=window)
    got = _launched("flash_attention", lambda: flash_attention(q, k, v, **kw))
    _attn_close(got, attention_ref(q, k, v, **kw))


def test_flash_attention_kernel_reads_strided_views(gen):
    """(B, S, H, D) memory seen as (B, H, S, D): the same bits as contiguous
    inputs, and the output keeps q's layout."""
    q = torch.randn(2, 77, 8, 64, generator=gen, device="cuda")
    k, v = (torch.randn(2, 77, 4, 64, generator=gen, device="cuda") for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = flash_attention(qt, kt, vt, scale=0.125, window=20, softcap=30.0)
    assert got.stride() == qt.stride()
    want = flash_attention(qt.contiguous(), kt.contiguous(), vt.contiguous(), scale=0.125,
                           window=20, softcap=30.0)
    assert torch.equal(got, want)


def test_flash_attention_kernel_refuses_what_it_does_not_take(gen):
    z = lambda h, d=64, dtype=torch.float32: torch.zeros(1, h, 8, d, device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(z(2, 16), z(2, 16), z(2, 16), scale=1.0)
    with pytest.raises(TypeError, match="unsupported dtypes"):
        flash_attention(z(2, dtype=torch.float16), z(2, dtype=torch.float16),
                        z(2, dtype=torch.float16), scale=1.0)
    x = torch.zeros(1, 2, 8, 128, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(x, x, x, scale=1.0)


# The bf16 route (tensor cores: wgmma, TMA, P split in two): ragged S (1, S
# below a key tile, 777), windows of 1, 9 and beyond S, softcap on and off,
# non-causal, Hq/Hkv of 36/36, 24/2 and 8/4, B·Hq above the card's 132 SMs,
# each at D = 64, 128 and 256, contiguous and as (B, S, H, D) views: every
# element within 2 bf16 ulps of attention_ref, one launch each.
TC_CASES = [
    # (B, Hq, Hkv, S, window, softcap, causal)
    (1, 8, 4, 1, None, None, True),
    (1, 8, 4, 40, None, 50.0, True),
    (2, 8, 4, 777, 9, 50.0, True),
    (1, 24, 2, 777, 1, None, True),
    (1, 36, 36, 300, 1000, 30.0, True),
    (2, 8, 4, 777, None, None, False),
    (1, 24, 2, 513, 9, None, False),
    (20, 8, 4, 200, None, 50.0, True),
]


@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd_view"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "B{}-Hq{}-Hkv{}-S{}-W{}-cap{}-{}".format(
    *c[:6], "causal" if c[6] else "full"))
def test_flash_attention_tensor_core_route(gen, case, d, strided):
    b, hq, hkv, s, window, softcap, causal = case
    if strided:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16().transpose(1, 2)
                   for h in (hq, hkv, hkv))
    else:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
                   for h in (hq, hkv, hkv))
    kw = dict(scale=d ** -0.5, causal=causal, window=window, softcap=softcap)
    before = _build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.stride() == q.stride()
    _attn_close(got, attention_ref(q, k, v, **kw))


def test_flash_attention_tensor_core_route_refuses_unaligned_rows(gen):
    """TMA reads rows at 16-byte steps: a bf16 view whose position stride is
    not a multiple of 8 elements is refused before the launch."""
    x = torch.zeros(1, 2, 8, 68, device="cuda", dtype=torch.bfloat16)[..., :64]
    before = _build.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(x, x, x, scale=1.0)
    assert _build.LAUNCHES["flash_attention"] == before


def test_smoke_model_on_the_card_equals_the_cpu(gen):
    """A gemma2-shaped smoke model at head_dim 64 (the kernel's smallest):
    the forward on the card goes through the kernel once per layer, decode
    through none, and both equal the CPU's plain route."""
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), head_dim=64,
                              query_scale=64 ** -0.5)
    model = M.init_params(cfg, device="cpu")
    model_gpu = M.init_params(cfg, device="cpu").to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    before = _build.LAUNCHES["flash_attention"]
    got, _, _ = M.forward(model_gpu, toks.cuda(), cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] - before == cfg.num_layers
    want, _, _ = M.forward(model, toks, cfg)
    _close(got.cpu(), want, 1e-4)
    caches = T.init_trunk_cache(cfg, 2, 4, "cuda")
    before = _build.LAUNCHES["flash_attention"]
    for t in range(4):
        M.decode_step(model_gpu, toks[:, t:t + 1].cuda(), t, caches, cfg)
    assert _build.LAUNCHES["flash_attention"] == before


# ---------------------------------------------------------------------------
# The serving core on the card
# ---------------------------------------------------------------------------


def _serve_problem(n=96, p=300, k=6):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, p, generator=g, dtype=torch.float64)
    y = torch.where(torch.arange(n) % 2 == 0, -1.0, 1.0).double()
    x[y > 0, :4] += 0.8
    yc = torch.arange(n) % 3
    return x, y, yc, k


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-9)])
def test_engine_on_the_card_equals_its_plain_route(gen, dtype, tol):
    """One batch of every CV kind through a CUDA engine (the kernels)
    against the kernels' plain versions called through ``core`` on CPU
    copies (``fused=True``) of the same plan, with the CUDA launches
    counted. (f32: decision values pass hat_apply, foldsolve and the bias
    adjust, each rounding on its own; the card's f32 route is held end to
    end at 1e-4, as in the tests above.)"""
    import dataclasses as dc

    from repro_torch.serve import CVEngine, EngineConfig, Workload, run_workloads

    x, y, yc, k = _serve_problem()
    cpu = CVEngine(EngineConfig(device="cpu"))
    card = CVEngine(EngineConfig(device="cuda"))
    assert card.device.type == "cuda" and card._fused
    h_cpu = cpu.register(x.to(dtype), folds.kfold(len(x), k, seed=0, device="cpu"), 5.0)
    h_card = card.register(x.to(dtype).cuda(), folds.kfold(len(x), k, seed=0, device="cuda"),
                           5.0)
    assert h_cpu.key == h_card.key
    _, plan = cpu.resolve(h_cpu)
    card.cache.put(h_card.key, fastcv.CVPlan(*(None if t is None else t.cuda() for t in (
        plan.h, plan.te_idx, plan.tr_idx, plan.chol_ih, plan.h_tr_te))))
    work = lambda h: [Workload(kind="cv", dataset=h, y=y),
                      Workload(kind="cv", dataset=h, y=torch.stack([y, -y, y], 1)),
                      Workload(kind="cv", dataset=h, y=y, estimator="ridge"),
                      Workload(kind="cv", dataset=h, y=yc, estimator="multiclass",
                               num_classes=3)]
    before = dict(_build.LAUNCHES)
    got = run_workloads(card, work(h_card))
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[n] > before[n] for n in ("hat_apply", "foldsolve", "fold_eval"))
    assert _build.LAUNCHES["gram"] == before["gram"]              # the plan was given
    yd = y.to(dtype)
    want = [fastcv.binary_dvals(plan, yd, fused=True),
            fastcv.binary_dvals(plan, torch.stack([yd, -yd, yd], 1), fused=True),
            fastcv.make_eval_cv(fused=True)(dc.replace(plan, h_tr_te=None), yd[:, None])[..., 0],
            multiclass.batch_predict(plan, yc[None], 3, fused=True)[0]]
    for a, b in zip(got[:3], want[:3]):
        assert a.values.device.type == "cuda"
        _close(a.values.cpu(), b, tol)
    assert torch.equal(got[3].values.cpu(), want[3])
    assert card.plans_built == 0


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_bucket_1024_null_on_the_card_equals_plain(gen, kind):
    """A permutation null at the bucket of T = 1,000 (one padded batch of
    1,024: hat_apply and foldsolve once each) against the same draws on
    the CPU's plain versions (the core evaluators with ``fused=True``), on
    one plan."""
    from repro_torch.core import metrics, permutation
    from repro_torch.serve import CVEngine, EngineConfig

    x, y, yc, k = _serve_problem()
    cpu = CVEngine(EngineConfig(device="cpu"))
    card = CVEngine(EngineConfig(device="cuda"))
    _, plan = cpu.plan(x, folds.kfold(len(x), k, seed=0, device="cpu"), 5.0)
    plan_card = fastcv.CVPlan(*(t.cuda() for t in (plan.h, plan.te_idx, plan.tr_idx,
                                                   plan.chol_ih, plan.h_tr_te)))
    perms = permutation.permutation_indices(0, len(x), 1024, device="cuda")
    labels = y if kind == "binary" else yc
    before = dict(_build.LAUNCHES)
    rows = labels[perms[:1000].cpu()]                                  # (1000, N)
    if kind == "binary":
        got = card.null_binary(plan_card, labels.cuda(), perms[:1000])
        yp = rows.T.contiguous()
        dv = fastcv.binary_dvals(plan, yp, fused=True)
        want = permutation._fold_metric_binary(dv, yp[plan.te_idx], "accuracy")
    else:
        got = card.null_multiclass(plan_card, labels.cuda(), perms[:1000], num_classes=3)
        hits = multiclass.batch_predict(plan, rows, 3, fused=True) == rows[:, plan.te_idx]
        want = metrics.share(hits.sum(dim=(1, 2)), hits.shape[1] * hits.shape[2])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["hat_apply"] - before["hat_apply"] == 1
    assert _build.LAUNCHES["foldsolve"] - before["foldsolve"] == 1
    # f64 shares of hits: the two routes' decision values differ at ~1e-15,
    # far inside any margin a hit could turn on
    assert got.shape == (1000,) and torch.equal(got.cpu(), want)


def test_plan_store_round_trip_on_the_card(gen, tmp_path):
    from repro_torch.serve import CVEngine, EngineConfig, PlanStore, Workload, run_workloads

    x, y, _, k = _serve_problem()
    xc = x.float().cuda()
    f = folds.kfold(len(x), k, seed=0, device="cuda")
    first = CVEngine(EngineConfig(device="cuda", plan_store=str(tmp_path), save_plans=True))
    (a,) = run_workloads(first, [Workload(kind="cv", dataset=first.register(xc, f, 5.0),
                                          y=y)])
    first.flush_store()
    assert first.plans_built == 1 and first.stats()["store_writes"] == 1
    second = CVEngine(EngineConfig(device="cuda", plan_store=str(tmp_path)))
    (b,) = run_workloads(second, [Workload(kind="cv", dataset=second.register(xc, f, 5.0),
                                           y=y)])
    assert second.plans_built == 0 and second.stats()["store_hits"] == 1
    assert b.values.device.type == "cuda" and torch.equal(a.values, b.values)
    key = second.register(xc, f, 5.0).key
    loaded = PlanStore(tmp_path, device="cuda").load(key)
    assert loaded.h.device.type == "cuda" and loaded.h.dtype == torch.float32


def test_default_engine_takes_the_card(gen):
    from repro_torch.serve import CVEngine

    engine = CVEngine()
    assert engine.device.type == "cuda" and engine._fused
    assert engine.store is None


def test_tracer_waits_for_the_card_only_with_a_trace(gen, monkeypatch):
    from repro_torch.serve.trace import Tracer

    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d) or real(d))
    tracer = Tracer(enabled=True)
    x = torch.ones(4, device="cuda")
    tracer.sync(x)
    assert calls == []
    with tracer.activate(tracer.trace()):
        tracer.sync((x, (torch.ones(2), x)))
    assert len(calls) == 1 and calls[0].type == "cuda"


# ---------------------------------------------------------------------------
# The serve edges on the card
# ---------------------------------------------------------------------------


def _edge_batch(h, y, yc):
    from repro_torch.serve import Workload

    y3 = np.stack([np.asarray(y), -np.asarray(y), np.asarray(y)], 1)
    return [Workload(kind="cv", dataset=h, y=y),
            Workload(kind="cv", dataset=h, y=y3),
            Workload(kind="cv", dataset=h, y=y, estimator="ridge"),
            Workload(kind="cv", dataset=h, y=yc, estimator="multiclass", num_classes=3),
            Workload(kind="permutation", dataset=h, y=y, n_perm=100, seed=1),
            Workload(kind="permutation", dataset=h, y=yc, estimator="multiclass",
                     num_classes=3, n_perm=50, seed=2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_on_the_card_equals_in_process_at_equal_buckets(gen, dtype):
    """One batch over HTTP and the same batch in process, on one engine on
    the card: the same workloads coalesce into the same buckets, so every
    decoded response equals its in-process one bit for bit, and the two
    runs launch the kernels equally often."""
    from repro_torch.serve import CVEngine, EdgeThread, EngineConfig, HTTPClient, run_workloads
    from repro_torch.serve.http import assert_responses_equal

    x, y, yc, k = _serve_problem()
    engine = CVEngine(EngineConfig(device="cuda"))
    h = engine.register(x.to(dtype).cuda(), folds.kfold(len(x), k, seed=0, device="cuda"), 5.0)
    yd, ycn = y.to(dtype).numpy(), yc.numpy()          # the wire's own inputs: arrays
    run_workloads(engine, _edge_batch(h, yd, ycn))               # every shape once
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    want = run_workloads(engine, _edge_batch(h, yd, ycn))
    torch.cuda.synchronize()
    in_process = {n: _build.LAUNCHES[n] - before[n] for n in before}
    compiles = engine.compile_count()
    with EdgeThread(engine) as edge, HTTPClient(edge.url) as hc:
        before = dict(_build.LAUNCHES)
        got = hc.gather(_edge_batch(h, yd, ycn))
        wire = {n: _build.LAUNCHES[n] - before[n] for n in before}
    for a, b in zip(got, want, strict=True):
        assert_responses_equal(a, b)
    assert wire == in_process and in_process["hat_apply"] > 0 and in_process["fold_eval"] > 0
    assert engine.compile_count() == compiles


def test_sse_on_the_card_equals_stream_workload_at_an_equal_chunk(gen):
    from repro_torch.serve import (CVEngine, EdgeThread, EngineConfig, HTTPClient, Workload,
                                   stream_workload)

    x, y, yc, k = _serve_problem()
    engine = CVEngine(EngineConfig(device="cuda"))
    h = engine.register(x.float().cuda(), folds.kfold(len(x), k, seed=0, device="cuda"), 5.0)
    w = Workload(kind="permutation", dataset=h, y=y.float(), n_perm=200, seed=3)
    want = list(stream_workload(engine, w, chunk=64))
    with EdgeThread(engine, stream_chunk=64) as edge, HTTPClient(edge.url) as hc:
        got = list(hc.stream(w))
    assert [(e.kind, e.done) for e in got] == [(e.kind, e.done) for e in want]
    for a, b in zip(got, want):
        if a.kind in ("observed", "null"):
            assert torch.equal(a.payload, b.payload.cpu())
    assert torch.equal(got[-1].payload.null, want[-1].payload.null.cpu())


def test_default_client_and_edge_take_the_card(gen):
    from repro_torch.serve import Client, EdgeThread

    client = Client()
    assert client.engine.device.type == "cuda" and client.engine._fused
    with EdgeThread() as edge:
        assert edge.engine.device.type == "cuda"


def test_distributed_over_nccl_at_world_size_one(gen, tmp_path):
    """core.distributed on a (1, 1) mesh of one NCCL rank: the feature-sharded
    Gram is the gram kernel's centered Gram and the sharded null is the local
    null, bit for bit (the same launches at the same widths)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D
    from repro_torch.core import permutation as perm_lib
    from repro_torch.kernels.gram.ops import centered_gram

    n, p, k, t = 300, 5000, 10, 64
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        x = torch.randn(n, p, generator=gen, device="cuda")
        y = torch.where(torch.arange(n, device="cuda") % 2 == 0, 1.0, -1.0)
        x[:, :20] += 0.5 * y[:, None]
        f = folds.kfold(n, k, seed=0, device="cuda")
        g = _launched("gram", lambda: D.distributed_gram(x, mesh))
        assert torch.equal(g, centered_gram(x))
        plan = fastcv.prepare(x, f, float(torch.diagonal(g).mean()), mode="dual", gram=g)
        perms = perm_lib.permutation_indices(0, n, t, device="cuda")
        got = _launched("hat_apply", lambda: D.sharded_null_from_plan(plan, y, perms, mesh))
        yp = y[perms].T.contiguous()
        want = perm_lib._fold_metric_binary(fastcv.binary_dvals(plan, yp), yp[plan.te_idx],
                                            "accuracy")
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()
