"""The arithmetic of gram's and hat_apply's f32 tensor-core routes, emulated
on the CPU in plain PyTorch and held against f64 and against the JAX
package's kernels (interpret mode) on the same numpy inputs.

The kernels (``csrc/upper_gram_tc.cuh``, ``csrc/hat_apply.cu``) round each
f32 value x to TF32 with round-to-nearest, ties away from zero (what
``cvt.rna.tf32.f32`` does; ``sm90::tf32_rna`` computes it with two integer
operations), split it into big = tf32(x) and small = tf32(x − big), and per
k8 step issue three TF32 products, big·small, small·big, big·big, into an
f32 accumulator. The tensor cores multiply TF32 values exactly and truncate
the f32 sum; each chunk of 32 columns starts a fresh accumulator that is
added, rounded to nearest, to a running total, and the contraction splits
are summed in a fixed order. The emulation does each k8 step's eight-term
sum in f64 and rounds the accumulator toward zero after it.

Tolerance: the port's f32 pin, 1e-5 of max |result| (``TOL`` of
``chip_smoke.py``, the reference's own for its f32 kernels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram.ops import gram as ref_gram
from repro.kernels.hat_apply.ops import hat_errors as ref_hat_errors
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.gram.gram import tc_gram_splits
from repro_torch.kernels.hat_apply.hat_apply import hat_splits

TOL = 1e-5
SMS = 132     # an H100's SMs: the split counts the kernels use there
CHUNK = 32    # contraction columns per chunk
K8 = 8        # contraction columns per TF32 wgmma step


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 as the kernel rounds: half a TF32 ulp added to the
    magnitude bits, the 13 bits below the TF32 fraction cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return bits.view(torch.float32)


def rna_reference(x: np.ndarray) -> np.ndarray:
    """Independent round-to-nearest-ties-away to 11 significant bits, in f64."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    scaled = np.abs(m) * 2.0 ** 11
    return (np.sign(m) * np.floor(scaled + 0.5) * 2.0 ** (e - 11)).astype(np.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def add_rz(acc: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """acc (f32) + terms (f64, exact), rounded toward zero to f32."""
    want = acc.double() + terms
    got = want.float()
    over = got.double().abs() > want.abs()
    return torch.where(over, torch.nextafter(got, torch.zeros_like(got)), got)


def emulate_product(a: torch.Tensor, b: torch.Tensor, splits: int, products: str = "3xtf32"):
    """A (M, K) · B (K, Nc) as the kernels compute it, K split into `splits`
    ranges of whole chunks summed in order; f32 result."""
    k = a.shape[1]
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    if products == "3xtf32":
        pairs = ((a_big, b_small), (a_small, b_big), (a_big, b_big))
    else:                                           # one TF32 product
        pairs = ((a_big, b_big),)
    span = cdiv(cdiv(k, splits), CHUNK) * CHUNK      # whole chunks a split
    out = None
    for s in range(splits):
        total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        for c0 in range(s * span, min(k, (s + 1) * span), CHUNK):
            part = torch.zeros_like(total)
            for k0 in range(c0, min(k, c0 + CHUNK), K8):
                for pa, pb in pairs:
                    part = add_rz(part, pa[:, k0:k0 + K8].double() @ pb[k0:k0 + K8].double())
            total = total + part
        out = total if out is None else out + total
    return out


def emulate_gram(x: torch.Tensor) -> torch.Tensor:
    g = emulate_product(x, x.T.contiguous(), tc_gram_splits(*x.shape, SMS))
    upper = torch.triu(g)
    return upper + torch.triu(g, diagonal=1).T     # mirrored from the upper triangle


def emulate_hat(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y - emulate_product(h, y, hat_splits(y.shape[0], y.shape[1], SMS))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4000) * np.exp2(rng.integers(-60, 60, size=4000)),
        # exact ties: 11 significant bits plus a half unit
        (rng.integers(1024, 2048, size=500) + 0.5) * np.exp2(rng.integers(-20, 20, size=500)),
        -(rng.integers(1024, 2048, size=500) + 0.5),
    ]).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, rna_reference(x))
    assert np.all((got.view(np.uint32) & 0x1FFF) == 0)


def test_split_recovers_x_to_2_pow_minus_22():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=100_000) * np.exp2(rng.integers(-30, 30, size=100_000)))
                         .astype(np.float32))
    big, small = split(x)
    resid = (x.double() - big.double() - small.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("n,p", [(8, 16), (130, 1037), (200, 5000)])
def test_3xtf32_gram_holds_the_f32_pin(n, p):
    x = np.random.default_rng(n + p).normal(size=(n, p)).astype(np.float32)
    got = emulate_gram(torch.from_numpy(x))
    assert torch.equal(got, got.T)
    exact = x.astype(np.float64) @ x.astype(np.float64).T
    assert rel(got, exact) <= TOL
    assert rel(got, ref_gram(jnp.asarray(x), interpret=True)) <= TOL


@pytest.mark.parametrize("n,p", [(8, 16), (130, 1037)])
def test_single_tf32_gram_misses_the_pin(n, p):
    """Why the kernel splits: one TF32 product per step keeps 11 significant
    bits of each factor, an error far above 1e-5 of max |G|."""
    x = np.random.default_rng(n + p).normal(size=(n, p)).astype(np.float32)
    xt = torch.from_numpy(x)
    single = emulate_product(xt, xt.T.contiguous(), tc_gram_splits(n, p, SMS), products="single")
    exact = x.astype(np.float64) @ x.astype(np.float64).T
    assert rel(single, exact) > TOL
    assert rel(emulate_gram(xt), exact) <= TOL / 10


@pytest.mark.parametrize("n,b", [(16, 1), (131, 70), (300, 250)])
def test_3xtf32_hat_apply_holds_the_f32_pin(n, b):
    rng = np.random.default_rng(n + b)
    h = (rng.normal(size=(n, n)) / n).astype(np.float32)
    y = rng.normal(size=(n, b)).astype(np.float32)
    got = emulate_hat(torch.from_numpy(h), torch.from_numpy(y))
    exact = y.astype(np.float64) - h.astype(np.float64) @ y.astype(np.float64)
    assert rel(got, exact) <= TOL
    assert rel(got, ref_hat_errors(jnp.asarray(h), jnp.asarray(y), interpret=True)) <= TOL


def test_split_counts_fill_the_card():
    # gram: 28 upper 128-row tiles at N = 787 → 14 splits, 392 blocks for
    # three waves of one block per SM; no split below 1,024 columns
    assert tc_gram_splits(787, 76000, SMS) == 14
    assert tc_gram_splits(787, 1500, SMS) == 2
    assert tc_gram_splits(8, 16, SMS) == 1
    assert tc_gram_splits(4096, 76000, SMS) == 1
    # hat_apply: 13 x 4 tiles at B = 250 → 5 splits, 260 blocks, two per SM;
    # no split below 64 columns
    assert hat_splits(787, 250, SMS) == 5
    assert hat_splits(787, 1, SMS) == 13
    assert hat_splits(16, 1, SMS) == 1
