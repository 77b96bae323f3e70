"""repro_torch kernels on the CPU: each wrapper's plain version against the
reference's Pallas kernel (interpret mode), on the same numpy inputs.

Tolerances: f64 ≤ 1e-9 relative (the reference's own pin); f32 ≤ 1e-5
relative to the result's largest magnitude (the fold_eval pin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro.kernels.fold_eval.ops import fold_eval as ref_fold_eval
from repro.kernels.foldsolve.ops import fold_jitter as ref_fold_jitter
from repro.kernels.foldsolve.ops import fold_residual_bad as ref_residual_bad
from repro.kernels.foldsolve.ops import foldsolve as ref_foldsolve
from repro.kernels.gram.ops import centered_gram_xla as ref_centered_gram_xla
from repro.kernels.gram.ops import gram as ref_gram
from repro.kernels.hat_apply.ops import hat_errors as ref_hat_errors
from repro.kernels.pairdist.ops import pairwise_sq_dists as ref_pairwise_sq_dists
from repro.kernels.pairdist.ref import pairwise_sq_dists_ref as ref_pairwise_sq_dists_ref
from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, default_fused
from repro_torch.kernels.flash_attention import flash_attention as flash_launch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fold_eval.ops import fold_eval
from repro_torch.kernels.fold_eval.ref import fold_eval_checked_ref, fold_eval_ref
from repro_torch.kernels.foldsolve.foldsolve import SMEM_BYTES, aug_in_shared, block_cols
from repro_torch.kernels.foldsolve.ops import fold_jitter, fold_residual_bad, foldsolve
from repro_torch.kernels.foldsolve.ref import (_residual_tol, foldsolve_checked_ref,
                                               foldsolve_ref)
from repro_torch.kernels.gram.gram import dmma_gram_splits, tc_gram_splits
from repro_torch.kernels.gram.ops import (PRECISIONS, centered_gram, centered_gram_plain,
                                          check_precision, gram)
from repro_torch.kernels.hat_apply.hat_apply import dmma_hat_splits
from repro_torch.kernels.hat_apply.ops import hat_errors
from repro_torch.kernels.pairdist import pairdist as pairdist_launch
from repro_torch.kernels.pairdist.ops import pairwise_sq_dists
from repro_torch.kernels.pairdist.ref import distance_from_partials_ref, pairwise_sq_dists_ref

TOL = {np.float64: 1e-9, np.float32: 1e-5}


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= TOL[dtype] * scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- gram ----

@pytest.mark.parametrize("n,p", [(8, 16), (100, 300), (130, 70), (33, 1000)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gram_matches_reference(n, p, dtype):
    x = _rng(n + p).normal(size=(n, p)).astype(dtype)
    got = gram(_t(x))
    assert got.dtype == _t(x).dtype
    _close(got, ref_gram(jnp.asarray(x), interpret=True), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_centered_gram_matches_reference(dtype):
    x = (_rng(3).normal(size=(64, 200)) + 5.0).astype(dtype)
    want = ref_gram(jnp.asarray(x), center=True, interpret=True)
    _close(centered_gram(_t(x)), want, dtype)
    _close(centered_gram_plain(_t(x)), ref_centered_gram_xla(jnp.asarray(x)), dtype)


def test_gram_bf16_matches_reference_and_bound():
    """bf16_gram: centre, cast, accumulate in f32 — the reference's numerics,
    inside the documented ~2·2⁻⁸‖X_c‖² bound."""
    x = _rng(21).normal(size=(96, 300)).astype(np.float32)
    got = gram(_t(x), center=True, precision="bf16_gram")
    assert got.dtype == torch.float32
    ref = np.asarray(ref_gram(jnp.asarray(x), center=True, precision="bf16_gram",
                              interpret=True))
    _close(got, ref, np.float32)
    _close(centered_gram_plain(_t(x), precision="bf16_gram"),
           ref_centered_gram_xla(jnp.asarray(x), precision="bf16_gram"), np.float32)
    xc = x.astype(np.float64) - x.astype(np.float64).mean(0)
    exact = xc @ xc.T
    assert float(np.max(np.abs(got.numpy() - exact))) < 4.0 * 2.0**-8 * np.max(np.abs(exact))


def test_gram_precision_names():
    assert PRECISIONS == ("fp32", "bf16_gram")
    assert check_precision(None) == "fp32"
    x = _t(_rng(22).normal(size=(32, 64)))
    assert torch.equal(gram(x, center=True), gram(x, center=True, precision="fp32"))
    with pytest.raises(ValueError, match="precision"):
        gram(x, precision="fp8")


# The f64 routes (FP64 tensor cores): gram fills whole waves of one 128-row
# block per SM, hat_apply up to three 64 x 64 blocks per SM; both split the
# contraction into whole chunks of 16 columns.
@pytest.mark.parametrize("n,p,splits,blocks", [
    (787, 76000, 14, 392),   # main size: 28 upper tiles, 3 waves of 132
    (384, 2304, 21, 126),    # lm_probe: 6 upper tiles, one wave (22 asked)
    (130, 1037, 17, 51),     # ragged: splits of at least 64 columns
    (8, 16, 1, 1),           # one split: one partial, then the reduce
    (4096, 76000, 1, 528),
])
def test_dmma_gram_splits_fill_the_card(n, p, splits, blocks):
    got = dmma_gram_splits(n, p, 132)
    tiles = cdiv(n, 128)
    assert got == splits and got * tiles * (tiles + 1) // 2 == blocks


@pytest.mark.parametrize("n,b,splits,blocks", [
    (787, 250, 7, 364),      # main size, a permutation chunk
    (384, 64, 24, 144),      # lm_probe's label chunk
    (787, 1, 25, 325),       # the x64 binary_cv label vector (30 asked)
    (16, 1, 1, 1),           # one split: Y − H·Y fused into the store
    (131, 70, 9, 54),
])
def test_dmma_hat_splits_fill_the_card(n, b, splits, blocks):
    got = dmma_hat_splits(n, b, 132)
    assert got == splits and got * cdiv(n, 64) * cdiv(b, 64) == blocks


# ----------------------------------------------------------- hat_apply ----

@pytest.mark.parametrize("n,b", [(16, 1), (100, 7), (73, 33), (130, 70)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hat_apply_matches_reference(n, b, dtype):
    rng = _rng(n + b)
    h = (rng.normal(size=(n, n)) / n).astype(dtype)
    y = rng.normal(size=(n, b)).astype(dtype)
    _close(hat_errors(_t(h), _t(y)),
           ref_hat_errors(jnp.asarray(h), jnp.asarray(y), interpret=True), dtype)


def test_hat_apply_1d():
    rng = _rng(9)
    h, y = rng.normal(size=(50, 50)) / 50, rng.normal(size=50)
    got = hat_errors(_t(h), _t(y))
    assert got.shape == (50,)
    _close(got, ref_hat_errors(jnp.asarray(h), jnp.asarray(y), interpret=True), np.float64)


# ----------------------------------------------------------- foldsolve ----

def _h_te(k, m, dtype, seed):
    a = _rng(seed).normal(size=(k, m, m)) / (3.0 * m ** 0.5)
    return np.einsum("kij,klj->kil", a, a).astype(dtype)


@pytest.mark.parametrize("k,m,b", [(5, 8, 1), (10, 20, 4), (4, 50, 16), (2, 1, 3), (7, 1, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_foldsolve_matches_reference(k, m, b, dtype):
    h_te = _h_te(k, m, dtype, k * m)
    e = _rng(k + m + b).normal(size=(k, m, b)).astype(dtype)
    got = foldsolve(_t(h_te), _t(e))
    _close(got, ref_foldsolve(jnp.asarray(h_te), jnp.asarray(e), interpret=True), dtype)


def test_foldsolve_1d_rhs():
    h_te = _h_te(6, 9, np.float64, 4)
    e = _rng(5).normal(size=(6, 9))
    got = foldsolve(_t(h_te), _t(e))
    assert got.shape == (6, 9)
    _close(got, ref_foldsolve(jnp.asarray(h_te), jnp.asarray(e), interpret=True), np.float64)


def _near_singular_h_te(k, m, seed=7):
    """H_Te blocks making I − H_Te singular to machine precision."""
    q, _ = np.linalg.qr(_rng(seed).normal(size=(m, m)))
    d = np.concatenate([np.ones(m - 1), [1e-14]])
    a = (q * d[None, :]) @ q.T                    # I − H_Te = Q diag(d) Qᵀ
    return np.tile((np.eye(m) - a)[None], (k, 1, 1))


def test_foldsolve_jitter_near_singular():
    """The retry keeps near-singular folds finite, matches the shifted LAPACK
    solve, and matches the reference's retried kernel output."""
    k, m, b = 3, 12, 4
    h_te = _near_singular_h_te(k, m)
    e = _rng(8).normal(size=(k, m, b))
    raw = foldsolve(_t(h_te), _t(e), jitter=None).numpy()
    got = foldsolve(_t(h_te), _t(e)).numpy()
    assert np.all(np.isfinite(got))
    eps = fold_jitter(_t(h_te)).numpy()
    np.testing.assert_array_equal(eps, np.asarray(ref_fold_jitter(jnp.asarray(h_te))))
    want = np.stack([np.linalg.solve(np.eye(m) - h_te[i] + eps[i] * np.eye(m), e[i])
                     for i in range(k)])
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-8
    ref = np.asarray(ref_foldsolve(jnp.asarray(h_te), jnp.asarray(e), interpret=True))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-8
    # the raw path really was pathological (else the test is vacuous)
    assert not np.all(np.isfinite(raw)) or np.max(np.abs(raw)) > 1e6 * np.max(np.abs(want))


def test_foldsolve_jitter_retries_only_bad_folds():
    """A mixed batch: healthy folds keep their first solve bit for bit."""
    m, b = 10, 3
    healthy = _h_te(2, m, np.float64, 31)
    h_te = np.concatenate([healthy[:1], _near_singular_h_te(1, m), healthy[1:]])
    e = _rng(32).normal(size=(3, m, b))
    bad = fold_residual_bad(_t(h_te), foldsolve(_t(h_te), _t(e), jitter=None), _t(e))
    assert bad.tolist() == [False, True, False]
    ref_bad = ref_residual_bad(jnp.asarray(h_te),
                               ref_foldsolve(jnp.asarray(h_te), jnp.asarray(e),
                                             interpret=True, jitter=None), jnp.asarray(e))
    assert np.asarray(ref_bad).tolist() == bad.tolist()
    got = foldsolve(_t(h_te), _t(e))
    raw = foldsolve(_t(h_te), _t(e), jitter=None)
    assert torch.equal(got[0], raw[0]) and torch.equal(got[2], raw[2])
    assert torch.isfinite(got).all()


def test_foldsolve_jitter_noop_when_well_conditioned():
    h_te = _h_te(4, 10, np.float64, 13)
    e = _rng(14).normal(size=(4, 10, 6))
    assert torch.equal(foldsolve(_t(h_te), _t(e)), foldsolve(_t(h_te), _t(e), jitter=None))
    with pytest.raises(ValueError, match="jitter"):
        foldsolve(_t(h_te), _t(e), jitter="always")


def test_foldsolve_shared_memory_boundary():
    """The augmented block moves to global scratch past 227 KB, at any m."""
    assert block_cols(250) == 64 and block_cols(1) == 1 and block_cols(250, 16) == 16
    assert aug_in_shared(78, 64, 4) and aug_in_shared(78, 64, 8)
    # f32 with 64 columns: the last m in shared memory is 208 (the block, two
    # row and two factor buffers, 100 elements of reduction scratch)
    last = max(m for m in range(1, 400) if aug_in_shared(m, 64, 4))
    assert last == 208
    w = last + 64
    assert (last * w + 2 * w + 2 * last + 100) * 4 <= SMEM_BYTES
    assert not aug_in_shared(last + 1, 64, 4)
    assert not aug_in_shared(393, 64, 4)          # K = 2 at N = 787
    assert aug_in_shared(1, 64, 8)                # leave-one-out


def test_residual_tol_is_the_kernels():
    """The kernel takes √ε as sqrt of the type's ε in double, rounded to the
    type (gauss_jordan.cuh::residual_tol); the plain version's
    float(eps) ** 0.5 rounds to the same value in each type."""
    assert np.float32(_residual_tol(torch.float32)) == np.float32(
        np.sqrt(np.float64(np.finfo(np.float32).eps)))
    assert _residual_tol(torch.float64) == np.sqrt(np.finfo(np.float64).eps) == 2.0 ** -26


def _later_tile_failure(b=130, m=12, seed=40):
    """Three folds; the middle one is near-singular, and its first 64
    right-hand sides lie off the near-null direction, so only columns of
    its second and third 64-column tiles fail the residual check."""
    healthy = _h_te(2, m, np.float64, seed)
    q, _ = np.linalg.qr(_rng(seed + 1).normal(size=(m, m)))
    d = np.concatenate([np.ones(m - 1), [1e-14]])
    h_te = np.stack([healthy[0], np.eye(m) - (q * d) @ q.T, healthy[1]])
    e = _rng(seed + 2).normal(size=(3, m, b))
    null = q[:, -1]
    e[1, :, :64] -= np.outer(null, null @ e[1, :, :64])
    return h_te, e


@pytest.mark.parametrize("kernel", ["foldsolve", "fold_eval"])
def test_retry_re_solves_a_fold_that_fails_only_in_a_later_tile(kernel):
    """The retry's decision is the fold's: a fold whose failing columns all
    lie past the first 64-column tile is solved again whole, as the
    reference does; the healthy folds keep the raw solve bit for bit."""
    h_te, e = _later_tile_failure()
    k, m, b = e.shape
    if kernel == "foldsolve":
        def port(jitter):
            return foldsolve(_t(h_te), _t(e), jitter=jitter)
        ref = ref_foldsolve(jnp.asarray(h_te), jnp.asarray(e), interpret=True)
        e_solved = e
    else:
        n = 40
        h_rows = _rng(43).normal(size=(k, m, n)) / n
        y = _rng(44).normal(size=(n, b))
        y_te = e + np.einsum("kmn,nb->kmb", h_rows, y)

        def port(jitter):
            return fold_eval(_t(h_rows), _t(h_te), _t(y), _t(y_te), jitter=jitter)
        ref = ref_fold_eval(jnp.asarray(h_rows), jnp.asarray(h_te), jnp.asarray(y),
                            jnp.asarray(y_te), interpret=True)
        e_solved = y_te - (_t(h_rows) @ _t(y)).numpy()
    raw, got = port(None), port("auto")
    per_tile = [fold_residual_bad(_t(h_te), raw[..., c:c + 64], _t(e_solved[..., c:c + 64]))
                for c in range(0, b, 64)]
    assert [t.tolist() for t in per_tile] == [[False, False, False], [False, True, False],
                                              [False, True, False]]
    assert torch.equal(got[0], raw[0]) and torch.equal(got[2], raw[2])
    assert not torch.equal(got[1, :, :64], raw[1, :, :64])      # the first tile too
    eps = fold_jitter(_t(h_te)).numpy()
    shifted = np.linalg.solve(np.eye(m) - h_te[1] + eps[1] * np.eye(m), e_solved[1])
    assert np.max(np.abs(got[1].numpy() - shifted)) <= 1e-8 * np.max(np.abs(shifted))
    ref = np.asarray(ref)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-8 * np.max(np.abs(ref))


def test_checked_refs_are_the_cpu_route():
    """foldsolve_checked_ref and fold_eval_checked_ref are what the wrappers
    run on the CPU with jitter="auto"; jitter=None runs the raw solve."""
    h_te, e = _later_tile_failure(b=70)
    assert torch.equal(foldsolve(_t(h_te), _t(e)), foldsolve_checked_ref(_t(h_te), _t(e)))
    assert torch.equal(foldsolve(_t(h_te), _t(e), jitter=None), foldsolve_ref(_t(h_te), _t(e)))
    h_rows, _, y, y_te = _fold_eval_problem(3, 12, 30, 70, np.float64)
    args = tuple(_t(a) for a in (h_rows, h_te, y, y_te))
    assert torch.equal(fold_eval(*args), fold_eval_checked_ref(*args))
    assert torch.equal(fold_eval(*args, jitter=None), fold_eval_ref(*args)[0])
    assert not torch.equal(fold_eval(*args), fold_eval(*args, jitter=None))


# ----------------------------------------------------------- fold_eval ----

def _fold_eval_problem(k, m, n, b, dtype, seed=0):
    rng = _rng(seed)
    h_rows = (rng.normal(size=(k, m, n)) / n).astype(dtype)
    y = rng.normal(size=(n, b)).astype(dtype)
    y_te = rng.normal(size=(k, m, b)).astype(dtype)
    return h_rows, _h_te(k, m, dtype, seed + 1), y, y_te


@pytest.mark.parametrize("k,m,n,b", [(5, 8, 40, 1), (4, 25, 100, 7), (3, 1, 130, 70),
                                     (2, 40, 80, 3)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fold_eval_matches_reference(k, m, n, b, dtype):
    h_rows, h_te, y, y_te = _fold_eval_problem(k, m, n, b, dtype, seed=k + m)
    got = fold_eval(_t(h_rows), _t(h_te), _t(y), _t(y_te))
    want = ref_fold_eval(jnp.asarray(h_rows), jnp.asarray(h_te), jnp.asarray(y),
                         jnp.asarray(y_te), interpret=True)
    _close(got, want, dtype)


def test_fold_eval_jitter_near_singular():
    k, m, n, b = 2, 8, 32, 5
    h_rows, _, y, y_te = _fold_eval_problem(k, m, n, b, np.float64)
    h_te = _near_singular_h_te(k, m)
    got = fold_eval(_t(h_rows), _t(h_te), _t(y), _t(y_te)).numpy()
    assert np.all(np.isfinite(got))
    e = y_te - np.einsum("kmn,nb->kmb", h_rows, y)
    eps = np.asarray(ref_fold_jitter(jnp.asarray(h_te)))
    want = np.stack([np.linalg.solve(np.eye(m) - h_te[i] + eps[i] * np.eye(m), e[i])
                     for i in range(k)])
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-8


# ------------------------------------------------------------ pairdist ----

@pytest.mark.parametrize("c,p", [(5, 30), (8, 128), (33, 500), (17, 1000),
                                 (pairdist_launch.S_THRESHOLD, 300),
                                 (pairdist_launch.S_THRESHOLD + 1, 300)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pairdist_matches_reference(c, p, dtype):
    """The reference's own sweep: ≤ 1e-5 (f32) / 1e-9 (f64) of max |D|; every
    entry ≥ 0 and the diagonal 0 within the same tolerance (its reference
    asserts)."""
    u = _rng(c * p).normal(size=(c, p)).astype(dtype)
    got = pairwise_sq_dists(_t(u))
    assert got.dtype == _t(u).dtype
    _close(got, ref_pairwise_sq_dists(jnp.asarray(u), interpret=True), dtype)
    d = got.numpy()
    assert np.all(d >= 0.0)
    assert np.max(np.abs(np.diag(d))) <= TOL[dtype] * np.max(np.abs(d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("c,route", [
    (1, "S"), (8, "S"),                                   # the RSA path's condition means
    (pairdist_launch.S_THRESHOLD, "S"), (pairdist_launch.S_THRESHOLD + 1, "T"),
    (128, "T"), (787, "T"),                               # a single-trial RDM
])
def test_pairdist_route_rule(c, route, dtype):
    """Few conditions take the bytes-bound route S, many patterns gram's
    tensor-core passes (route T); S takes every C up to the threshold."""
    assert pairdist_launch.pairdist_route(c, 76000, dtype) == route
    assert pairdist_launch.S_THRESHOLD <= pairdist_launch.S_MAX_C


# Route S: about one block per SM, each over a whole number of 16-column
# pieces (so every dtype's 16-byte pieces start on a block's edge), never
# fewer than 256 columns; together the blocks cover P exactly once. The
# grid does not depend on C: every block reads all C rows.
@pytest.mark.parametrize("p,blocks,cols", [
    (76000, 132, 576),   # the RSA path's U (8, 76,000): one block per SM
    (30, 1, 256),        # a short P: one block
    (1037, 5, 256),      # a ragged P: the last block takes 13 columns
    (20000, 79, 256),    # 152 columns a block asked: 256, on 79 blocks
])
def test_pairdist_s_grid_fills_the_card(p, blocks, cols):
    got = pairdist_launch.s_grid(p, 132)
    assert got == (blocks, cols)
    assert cols % pairdist_launch.S_COL_ALIGN == 0
    assert (blocks - 1) * cols < p <= blocks * cols
    assert blocks <= 132 or cols == pairdist_launch.S_MIN_COLS


@pytest.mark.parametrize("c,entries", [(1, 64), (8, 64), (9, 192), (64, 36 * 64), (128, 136 * 64)])
def test_pairdist_s_workspace_holds_every_upper_tile(c, entries):
    assert pairdist_launch.s_workspace_entries(c) == entries


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairdist_t_epilogue_is_exactly_symmetric(dtype):
    """Route T's reduce, emulated: split partials whose diagonal 128-row
    tiles are not symmetric (as 3×TF32's big·small + small·big leaves them)
    still give an exactly symmetric D with an exactly zero diagonal, within
    the pin of the plain version, because only the element upper triangle
    is read and the norms are the summed diagonal."""
    rng = _rng(11)
    c, p = 150, 5000
    splits = tc_gram_splits(c, p, 132)
    assert splits > 1
    u = rng.normal(size=(c, p)).astype(dtype)
    parts = np.stack([u[:, k] @ u[:, k].T for k in np.array_split(np.arange(p), splits)])
    # below the diagonal: inside the two diagonal 128-row tiles, the
    # products' own rounding, not their mirror's; below them, never written
    eps = np.finfo(dtype).eps
    lower = np.tril(rng.normal(size=parts.shape) * eps * np.abs(parts), -1)
    lower[:, 128:, :128] = np.nan
    ws = _t((parts + lower).astype(dtype))
    assert not torch.equal(ws[0, :128, :128], ws[0, :128, :128].T)
    d = distance_from_partials_ref(ws)
    assert d.dtype == ws.dtype and torch.equal(d, d.T)
    assert not bool(torch.diagonal(d).any()) and bool((d >= 0).all())
    _close(d, pairwise_sq_dists_ref(_t(u)), dtype)
    assert torch.equal(d, distance_from_partials_ref(torch.triu(ws)))   # lower never read


def test_pairdist_bf16_accumulates_in_f32():
    """bf16 in, f32 out: held against the plain version of the f32 cast
    (the reference's oracle, which casts first)."""
    u = torch.from_numpy(_rng(5).normal(size=(9, 300)).astype(np.float32)).to(torch.bfloat16)
    got = pairwise_sq_dists(u)
    assert got.dtype == torch.float32
    assert torch.equal(got, pairwise_sq_dists_ref(u.float()))
    _close(got, ref_pairwise_sq_dists_ref(jnp.asarray(u.float().numpy()).astype(jnp.bfloat16)),
           np.float32)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32, torch.complex64])
def test_pairdist_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError, match="unsupported dtype"):
        pairwise_sq_dists(torch.zeros(3, 4, dtype=dtype))
    with pytest.raises(ValueError, match="2-D"):
        pairwise_sq_dists(torch.zeros(3, 4, 5))


def test_pairdist_cpu_and_meta_never_reach_the_build(monkeypatch):
    """A CPU tensor takes the plain version; a tensor on any other device
    than CUDA is refused before the kernel's build or launch."""
    def refuse(*a, **k):
        raise AssertionError("_build reached")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    u = _t(_rng(1).normal(size=(6, 40)))
    assert torch.equal(pairwise_sq_dists(u), pairwise_sq_dists_ref(u))
    with pytest.raises(ValueError, match="CUDA"):
        pairdist_launch.pairdist_cuda(torch.zeros(6, 40, device="meta"))


# ----------------------------------------------------- flash attention ----
# Tolerances: f32 ≤ 2e-5 of max |out| (the same f32 softmax, summed in
# another order); bf16 I/O within 2 bf16 ulps of each element (both sides
# compute in f32 and round once, so a ~1e-7 difference can move the
# rounding by one ulp; the second is headroom), the ulp taken at no less
# than 2^-8 of max |out| (smaller outputs come from cancellation, where
# that f32 difference is several of their own ulps).
TOL_ATTN_F32 = 2e-5


def _qkv(seed, b, hq, hkv, s, d, amp=1.0):
    rng = _rng(seed)
    return tuple((amp * rng.normal(size=(b, h, s, d))).astype(np.float32)
                 for h in (hq, hkv, hkv))


def _bf16_ulps(got, want):
    """max |got − want| in units of the bf16 ulp at |want|, floored at
    2^-8 of max |want|."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    mag = np.maximum(np.abs(want), np.max(np.abs(want)) / 256)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _both_refs(q, k, v, **kw):
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    return (ref_flash_attention(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw),
            ref_attention_ref(jq, jk, jv, **kw))


def _flash_close(got, wants):
    for want in wants:
        scale = float(np.max(np.abs(np.asarray(want))))
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL_ATTN_F32 * scale


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("s", [32, 128, 200])
def test_flash_causal_gqa_matches_reference(hq, hkv, s):
    q, k, v = _qkv(s + hq, 2, hq, hkv, s, 16)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.25)
    assert got.dtype == torch.float32 and got.shape == (2, hq, s, 16)
    _flash_close(got, _both_refs(q, k, v, scale=0.25))


@pytest.mark.parametrize("window", [16, 64])
def test_flash_local_window_matches_reference(window):
    q, k, v = _qkv(window, 1, 2, 2, 128, 8)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.3, window=window)
    _flash_close(got, _both_refs(q, k, v, scale=0.3, window=window))


def test_flash_softcap_matches_reference():
    q, k, v = _qkv(7, 1, 2, 2, 64, 8, amp=3.0)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.5, softcap=20.0)
    _flash_close(got, _both_refs(q, k, v, scale=0.5, softcap=20.0))


def test_flash_window_softcap_gqa_matches_reference():
    """gemma2's local layers: window and softcap together, Hq = 2·Hkv."""
    q, k, v = _qkv(8, 2, 4, 2, 96, 16, amp=2.0)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.25, window=24, softcap=50.0)
    _flash_close(got, _both_refs(q, k, v, scale=0.25, window=24, softcap=50.0))


def test_flash_bf16_io_matches_reference():
    q, k, v = _qkv(10, 1, 2, 2, 64, 16)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (qb, kb, vb))
    got = flash_attention(tq, tk, tv, scale=0.25)
    assert got.dtype == torch.bfloat16
    for want in (ref_flash_attention(qb, kb, vb, scale=0.25, block_q=32, block_k=32,
                                     interpret=True),
                 ref_attention_ref(qb, kb, vb, scale=0.25)):
        assert want.dtype == jnp.bfloat16
        assert _bf16_ulps(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 2.0


def test_flash_strided_views_and_non_causal():
    """The wrapper takes transposed views as they are (the model's layout),
    and causal=False attends to every key."""
    q, k, v = _qkv(11, 1, 4, 2, 40, 8)
    as_bshd = lambda a: _t(a.transpose(0, 2, 1, 3)).transpose(1, 2)   # (B, H, S, D) view
    got = flash_attention(as_bshd(q), as_bshd(k), as_bshd(v), scale=0.3, window=9)
    assert torch.equal(got, attention_ref(_t(q), _t(k), _t(v), scale=0.3, window=9))
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.3, causal=False)
    want = ref_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3, causal=False)
    scale = float(np.max(np.abs(np.asarray(want))))
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL_ATTN_F32 * scale


def test_flash_decode_offset_matches_reference():
    """The plain version aligns the ends when S_q < S_kv (the decode offset)."""
    rng = _rng(12)
    q = rng.normal(size=(1, 4, 5, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 30, 8)).astype(np.float32) for _ in range(2))
    got = attention_ref(_t(q), _t(k), _t(v), scale=0.3, window=12, softcap=5.0)
    want = ref_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3, window=12,
                             softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("route", sorted(flash_launch.TILES))
@pytest.mark.parametrize("s,window,causal", [(200, None, True), (200, 16, True), (1000, 100, True),
                                             (130, 64, True), (8192, 4096, True),
                                             (200, None, False), (150, 40, False)])
def test_flash_key_tiles_are_exactly_the_reachable_ones(s, window, causal, route):
    """Each route's key-tile range per query block covers every (q, k) pair
    the mask keeps and no tile without one (the Pallas kernel's skip)."""
    bq, bk = flash_launch.TILES[route]
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= q >= k
    if window is not None:
        keep &= q - k < window
    n_q, n_k = cdiv(s, bq), cdiv(s, bk)
    keep = np.pad(keep, ((0, n_q * bq - s), (0, 0)))           # rows past S keep nothing
    tiles = keep.reshape(n_q, bq, s).any(axis=1)               # (query block, key)
    for qt in range(n_q):
        lo, hi = flash_launch.key_tile_range(qt * bq, s, window, causal, (bq, bk))
        reach = [kt for kt in range(n_k) if tiles[qt, kt * bk:(kt + 1) * bk].any()]
        assert reach == list(range(lo, hi + 1)), (qt, lo, hi)


def test_flash_rejects_what_the_kernel_does_not_take():
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype)
    with pytest.raises(TypeError, match="unsupported dtypes"):
        flash_attention(z(1, 2, 8, 16, dtype=torch.float16), z(1, 2, 8, 16, dtype=torch.float16),
                        z(1, 2, 8, 16, dtype=torch.float16), scale=1.0)
    with pytest.raises(TypeError, match="unsupported dtypes"):
        flash_attention(z(1, 2, 8, 16), z(1, 2, 8, 16, dtype=torch.float64), z(1, 2, 8, 16),
                        scale=1.0)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(z(1, 3, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16), scale=1.0)
    with pytest.raises(ValueError, match="window"):
        flash_attention(z(1, 2, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16), scale=1.0, window=0)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(z(2, 8, 16), z(2, 8, 16), z(2, 8, 16), scale=1.0)


def test_flash_cpu_never_reaches_the_build_and_meta_is_refused(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("_build reached")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    q, k, v = (_t(a) for a in _qkv(13, 1, 2, 1, 16, 64))
    assert torch.equal(flash_attention(q, k, v, scale=0.1), attention_ref(q, k, v, scale=0.1))
    meta = lambda h, d=64: torch.zeros((1, h, 16, d), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_launch.flash_attention_cuda(meta(2), meta(1), meta(1), scale=0.1, causal=True,
                                          window=None, softcap=None)


# ------------------------------------------------------------ dispatch ----

def test_common_helpers():
    assert cdiv(787, 64) == 13 and cdiv(64, 64) == 1
    assert default_fused("cuda") and default_fused(torch.device("cuda", 0))
    assert not default_fused("cpu")


@pytest.mark.parametrize("call", [
    lambda t: gram(t((6, 20))),
    lambda t: hat_errors(t((6, 6)), t((6, 2))),
    lambda t: foldsolve(t((2, 3, 3)), t((2, 3, 1)), jitter=None),
    lambda t: fold_eval(t((2, 3, 6)), t((2, 3, 3)), t((6, 1)), t((2, 3, 1)), jitter=None),
    lambda t: pairwise_sq_dists(t((5, 30))),
    lambda t: flash_attention(t((1, 2, 8, 64)), t((1, 1, 8, 64)), t((1, 1, 8, 64)), scale=0.1),
], ids=["gram", "hat_apply", "foldsolve", "fold_eval", "pairdist", "flash_attention"])
def test_non_cpu_tensor_never_takes_the_plain_version(call):
    """Only a CPU tensor reaches the plain version: any other device goes to
    the kernel route, which refuses what is not a CUDA tensor."""
    with pytest.raises(ValueError, match="CUDA"):
        call(lambda shape: torch.zeros(shape, device="meta"))

