"""Model-RDM comparison: rank correlations, cosine, permutation nulls.

RSA's second half: vectorise the empirical RDM's upper triangle, score it
against each candidate model RDM, and calibrate with a condition-label
permutation test — permuting condition identities (rows+columns of the
empirical RDM jointly) is the standard exchangeable null for RDM
correlations. Permutations come from
:func:`repro_torch.core.permutation.permutation_indices`.

Every score works along the last dimension and broadcasts over the leading
ones, so a whole null — T permutations × M models — is one batched
computation. Sizes are tiny (B = C(C−1)/2 pairs), so the O(B²) Kendall
pairwise form is the right trade against a sort-based O(B log B) one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "upper_triangle",
    "rankdata",
    "pearson",
    "spearman",
    "kendall",
    "cosine",
    "compare_rdms",
    "permutation_null",
    "make_compare",
    "make_compare_null",
]

_EPS = 1e-12


def upper_triangle(rdm: torch.Tensor) -> torch.Tensor:
    """Vectorise the strict upper triangle of (..., C, C) into (..., B)."""
    iu, ju = np.triu_indices(rdm.shape[-1], 1)
    return rdm[..., torch.from_numpy(iu).to(rdm.device), torch.from_numpy(ju).to(rdm.device)]


def rankdata(v: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based, ties get mid-ranks) along the last dimension."""
    sv, order = torch.sort(v, dim=-1, stable=True)
    first = torch.searchsorted(sv, sv, side="left")
    last = torch.searchsorted(sv, sv, side="right")
    mid = 0.5 * (first + last + 1).to(v.dtype)
    return torch.zeros_like(v).scatter_(-1, order, mid)


def pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ac = a - a.mean(dim=-1, keepdim=True)
    bc = b - b.mean(dim=-1, keepdim=True)
    denom = torch.sqrt((ac * ac).sum(dim=-1) * (bc * bc).sum(dim=-1))
    return (ac * bc).sum(dim=-1) / torch.clamp(denom, min=_EPS)


def spearman(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spearman ρ = Pearson correlation of average ranks."""
    return pearson(rankdata(a), rankdata(b))


def kendall(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kendall τ-b (tie-corrected), via the O(B²) pairwise sign form."""
    da = torch.sign(a[..., :, None] - a[..., None, :])
    db = torch.sign(b[..., :, None] - b[..., None, :])
    s = 0.5 * (da * db).sum(dim=(-2, -1))            # concordant − discordant
    n = a.shape[-1]
    n0 = 0.5 * n * (n - 1)
    ties_a = 0.5 * ((da == 0).sum(dim=(-2, -1)).to(a.dtype) - n)   # tied pairs in a
    ties_b = 0.5 * ((db == 0).sum(dim=(-2, -1)).to(b.dtype) - n)
    denom = torch.sqrt((n0 - ties_a) * (n0 - ties_b))
    return s / torch.clamp(denom, min=_EPS)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    denom = torch.sqrt((a * a).sum(dim=-1) * (b * b).sum(dim=-1))
    return (a * b).sum(dim=-1) / torch.clamp(denom, min=_EPS)


_METHODS = {
    "spearman": spearman,
    "kendall": kendall,
    "pearson": pearson,
    "cosine": cosine,
}


def _method(name: str):
    fn = _METHODS.get(name)
    if fn is None:
        raise ValueError(
            f"unknown comparison {name!r}; expected one of {tuple(_METHODS)}")
    return fn


def compare_rdms(empirical: torch.Tensor, model_rdms: torch.Tensor,
                 method: str = "spearman") -> torch.Tensor:
    """Score (M, C, C) model RDMs against the (C, C) empirical RDM → (M,)."""
    fn = _method(method)
    return fn(upper_triangle(empirical)[None, :], upper_triangle(model_rdms))


def permutation_null(empirical: torch.Tensor, model_rdms: torch.Tensor,
                     perms: torch.Tensor, method: str = "spearman") -> torch.Tensor:
    """(M, T) null scores: condition labels permuted per perms (T, C).

    Permuting the empirical RDM's rows and columns jointly (not the model
    RDMs) yields one draw from the no-correspondence null per permutation.
    """
    fn = _method(method)
    mv = upper_triangle(model_rdms)                                   # (M, B)
    permuted = empirical[perms[:, :, None], perms[:, None, :]]         # (T, C, C)
    ev = upper_triangle(permuted)                                     # (T, B)
    return fn(ev[:, None, :], mv[None, :, :]).T                       # (M, T)


def make_compare(method: str = "spearman"):
    """Scorer ``(empirical (C, C), models (M, C, C)) -> (M,)``."""
    return functools.partial(compare_rdms, method=method)


def make_compare_null(method: str = "spearman"):
    """Null ``(empirical, models, perms (T, C)) -> (M, T)``."""
    return functools.partial(permutation_null, method=method)
