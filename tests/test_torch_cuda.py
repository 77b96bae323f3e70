"""repro_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason.
On a machine with one: ``PYTHONPATH=src python -m pytest -q -m cuda
--noconftest tests/test_torch_cuda.py`` (the first test builds the kernels
with nvcc; ``--noconftest`` skips the root conftest, which configures jax).
"""

import pytest
import torch

from repro_torch.core import fastcv, folds
from repro_torch.kernels import _build
from repro_torch.kernels.fold_eval.ops import fold_eval
from repro_torch.kernels.fold_eval.ref import fold_eval_ref
from repro_torch.kernels.foldsolve.ops import fold_jitter, foldsolve
from repro_torch.kernels.foldsolve.ref import foldsolve_ref
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.gram.ref import gram_ref
from repro_torch.kernels.hat_apply.ops import hat_errors
from repro_torch.kernels.hat_apply.ref import hat_apply_ref

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


def _h_te(gen, k, m, dtype):
    a = torch.randn(k, m, m, generator=gen, device="cuda", dtype=dtype) / (3 * m ** 0.5)
    return -(a @ a.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,m,b", [(40, 1, 3), (10, 78, 250), (3, 17, 70), (2, 230, 5)])
def test_foldsolve_kernel(gen, dtype, k, m, b):
    h_te = _h_te(gen, k, m, dtype)
    e = torch.randn(k, m, b, generator=gen, device="cuda", dtype=dtype)
    got = _launched("foldsolve", lambda: foldsolve(h_te, e, jitter=None))
    _close(got, foldsolve_ref(h_te, e), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,m,n,b", [(10, 78, 787, 1), (3, 17, 131, 70), (2, 230, 460, 3)])
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


def test_binary_cv_on_the_card_equals_the_cpu(gen):
    x = torch.randn(60, 300, generator=gen, device="cuda", dtype=torch.float64)
    y = torch.where(torch.arange(60, device="cuda") % 2 == 0, 1.0, -1.0).double()
    gpu = fastcv.binary_cv(x, y, folds.kfold(60, 5, device="cuda"), 50.0)[0]
    cpu = fastcv.binary_cv(x.cpu(), y.cpu(), folds.kfold(60, 5, device="cpu"), 50.0)[0]
    _close(gpu.cpu(), cpu, 1e-9)
