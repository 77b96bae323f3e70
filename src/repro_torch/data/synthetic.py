"""Simulated classification/regression data (paper §2.12).

"Each class centroid is randomly placed on the surface of a unit
hypersphere in feature space. A common covariance matrix is randomly
sampled from a Wishart distribution. Samples are then created by randomly
sampling from a multivariate normal distribution parameterised by the
corresponding class centroid and the common covariance matrix."

Draws come from one ``torch.Generator`` seeded with ``seed`` on the target
device, so they differ from the reference's ``jax.random`` streams; tests
compare the two packages on shared arrays, and these generators on shape
and statistics.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["make_classification", "make_regression"]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _wishart_cholesky(gen: torch.Generator, p: int, dof: int, dtype,
                      device: torch.device) -> torch.Tensor:
    """Cholesky factor of a Wishart(I, dof)/dof sample, A = GᵀG/dof with
    G ~ N(0,1)^{dof×p} (dof >= p). Builds a (dof, p) factor: keep P modest."""
    g = torch.randn((dof, p), generator=gen, dtype=dtype, device=device)
    a = g.T @ g / dof + 1e-6 * torch.eye(p, dtype=dtype, device=device)
    return torch.linalg.cholesky(a)


def make_classification(seed: int, n: int, p: int, num_classes: int = 2,
                        dtype=torch.float64, class_sep: float = 1.0, *,
                        device=None):
    """Paper §2.12 generator. Returns (x (N,P), y int32 (N,) in [0, C)).

    Equal class proportions; centroids uniform on the unit hypersphere
    scaled by ``class_sep``; shared Wishart covariance.
    """
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    cent = torch.randn((num_classes, p), generator=gen, dtype=dtype, device=dev)
    cent = class_sep * cent / torch.linalg.norm(cent, dim=1, keepdim=True)
    chol = _wishart_cholesky(gen, p, max(p, 2 * p), dtype, dev)
    y = torch.arange(n, dtype=torch.int32, device=dev) % num_classes
    z = torch.randn((n, p), generator=gen, dtype=dtype, device=dev)
    return cent[y] + z @ chol.T, y


def make_regression(seed: int, n: int, p: int, noise: float = 0.1,
                    dtype=torch.float64, *, device=None):
    """Linear model y = Xw* + b* + ε for regression CV tests/benchmarks."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    x = torch.randn((n, p), generator=gen, dtype=dtype, device=dev)
    w = torch.randn((p,), generator=gen, dtype=dtype, device=dev) / p ** 0.5
    e = torch.randn((n,), generator=gen, dtype=dtype, device=dev)
    return x, x @ w + 0.5 + noise * e
