"""Distributed analytical CV on ``torch.distributed`` (paper §4.2).

The paper's workload decomposes onto a device mesh as:

  * feature axis (``"model"``): the O(N²P) Gram reduction. Each rank
    computes a partial X_c X_cᵀ over its feature block with the ``gram``
    kernel, and one ``all_reduce`` combines them. This is the only
    collective over the feature axis in the whole CV pipeline.
  * permutation axes (``"data"``): Algorithm 1's T permutations are
    independent given H. Each rank evaluates its slice against the
    replicated (N×N) hat matrix and fold blocks.
  * problem axes (``"pod"``, ``"data"``): searchlights, time points and
    RSA sweeps are independent CV problems, with no traffic between
    problems until the final gather.

N is bounded by the paper's premise (P ≫ N, N ≤ ~10⁴), so H and the fold
blocks are replicated; what scales (features, permutations, problems) is
sharded.

**The collective contract.** ``torch.distributed`` runs one process per
rank, so every function here is a collective call:

  * every rank of the mesh calls it with the same arguments, in the same
    order;
  * the inputs are the full tensors on every rank, as the reference's
    global arrays are;
  * each rank takes its slice by its coordinate on the mesh;
  * the output is the full result, replicated on every rank
    (``all_reduce`` / ``all_gather``).

A call that one rank makes alone waits in its collective until the
process group's timeout.

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims (``"data"``, ``"model"``, ``"pod"``). Where several axes are named,
those present in ``mesh.mesh_dim_names`` are used, in the order given, and
the work is sharded over their row-major product; the gather runs over
each axis's group in turn, from the last to the first, which concatenates
the shards in that order. The process group's backend follows the mesh's
device type (NCCL for ``cuda``, gloo for ``cpu``) and the inputs must lie
on that device type: nothing falls back from one to the other.

Where the reference closes a ``shard_map`` over a plan whose ``h`` came out
of another ``shard_map`` sharded, the port's plan is built by
``fastcv.prepare`` from the reduced Gram and is a plain replicated tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core import fastcv, metrics
from repro_torch.core import permutation as perm_lib
from repro_torch.core.folds import Folds
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.gram.ops import gram

__all__ = [
    "distributed_gram",
    "distributed_hat_matrix",
    "distributed_permutation_binary",
    "sharded_null_from_plan",
    "sharded_problems",
    "searchlight_cv",
]

_GRAM_DTYPES = (torch.float32, torch.float64)


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _require_axes(mesh, axes: Sequence[str]) -> None:
    missing = [a for a in axes if a not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(f"mesh dims {mesh.mesh_dim_names} lack the axes {missing}")


def _require_device(mesh, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f"the mesh is on {mesh.device_type} but a tensor is on "
                             f"{t.device.type}")


def _present(mesh, axes: Sequence[str]) -> tuple:
    return tuple(a for a in axes if a in (mesh.mesh_dim_names or ()))


def _shard(mesh, axes: tuple) -> tuple[int, int]:
    """(this rank's shard index, the shard count) over ``axes`` row-major."""
    index, count = 0, 1
    for a in axes:
        size = _axis_size(mesh, a)
        index, count = index * size + mesh.get_local_rank(a), count * size
    return index, count


def _gather(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Concatenate every shard's ``t`` along dim 0, in shard order."""
    t = t.contiguous()
    for a in reversed(axes):
        group = mesh.get_group(a)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts)
    return t


def distributed_gram(x: torch.Tensor, mesh, *, center: bool = True,
                     feature_axis: str = "model") -> torch.Tensor:
    """G_c = X_c X_cᵀ with X's features split over ``feature_axis``.

    The rank takes its contiguous column block (P need not divide), forms
    its partial Gram with the ``gram`` kernel (centered by the block's
    column means, which are the global ones), and one ``all_reduce(SUM)``
    over the feature axis combines the partials. On a feature axis of size
    1 the result is ``centered_gram(x)`` bit for bit. fp32 and f64 only.
    """
    _require_axes(mesh, (feature_axis,))
    _require_device(mesh, x)
    if x.dtype not in _GRAM_DTYPES:
        raise TypeError(f"distributed_gram takes float32 or float64, got {x.dtype}")
    size = _axis_size(mesh, feature_axis)
    block = torch.tensor_split(x, size, dim=1)[mesh.get_local_rank(feature_axis)]
    g = gram(block.contiguous(), center=center)
    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.get_group(feature_axis))
    return g


def distributed_hat_matrix(x: torch.Tensor, lam: float, mesh,
                           feature_axis: str = "model") -> torch.Tensor:
    """Dual hat matrix from the feature-sharded Gram (λ > 0)."""
    g = distributed_gram(x, mesh, center=True, feature_axis=feature_axis)
    return fastcv.hat_matrix_dual(x, lam, gram=g)


def distributed_permutation_binary(
    x: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float, n_perm: int,
    seed: int, mesh, *, metric: str = "accuracy", perm_axes: tuple = ("data",),
    feature_axis: str = "model", adjust_bias: bool = True,
) -> perm_lib.PermutationResult:
    """Algorithm 1 at scale: the Gram sharded over features, the
    permutations over ``perm_axes``. T is padded up to a whole number of
    shards with further draws and the null trimmed back to ``n_perm``.

    The plan is always dual, as the reference builds it (``prepare``'s
    ``"auto"`` would take primal at P < N and refuse the Gram). Draws come
    from ``seed`` through ``core.permutation.permutation_indices``.
    """
    _require_axes(mesh, perm_axes)
    g = distributed_gram(x, mesh, center=True, feature_axis=feature_axis)
    plan = fastcv.prepare(x, folds, lam, mode="dual", gram=g, with_train_block=adjust_bias)
    y = y.to(plan.h.dtype)
    dv_obs = fastcv.binary_dvals(plan, y, adjust_bias=adjust_bias)
    observed = perm_lib._fold_metric_binary(dv_obs, y[plan.te_idx], metric)

    shards = _shard(mesh, perm_axes)[1]
    perms = perm_lib.permutation_indices(seed, y.shape[0], cdiv(n_perm, shards) * shards,
                                         device=y.device)
    null = sharded_null_from_plan(plan, y, perms, mesh, metric=metric, perm_axes=perm_axes,
                                  adjust_bias=adjust_bias)[:n_perm]
    return perm_lib.PermutationResult(observed, null, perm_lib.p_value(observed, null))


def sharded_null_from_plan(plan: fastcv.CVPlan, y: torch.Tensor, perms: torch.Tensor,
                           mesh, *, metric: str = "accuracy",
                           perm_axes: tuple = ("data",),
                           adjust_bias: bool = True) -> torch.Tensor:
    """Null-distribution metrics for ``perms`` (T, N), T sharded over
    ``perm_axes``; the plan (hat matrix and fold blocks) is replicated.

    The serve engine's distributed permutation path: the plan is built once
    (through :func:`distributed_gram` on a mesh engine) and every batch of
    permutations fans out over the mesh's data axes. T must divide by the
    product of the perm-axis sizes.
    """
    _require_axes(mesh, perm_axes)
    _require_device(mesh, plan.h, y, perms)
    index, shards = _shard(mesh, perm_axes)
    t = perms.shape[0]
    if t % shards:
        raise ValueError(f"{t} permutations do not divide over {shards} shards of "
                         f"{tuple(perm_axes)}")
    local = t // shards
    yp = y[perms[index * local:(index + 1) * local]].T.contiguous()     # (N, T_local)
    dv = fastcv.binary_dvals(plan, yp, adjust_bias=adjust_bias)
    return _gather(perm_lib._fold_metric_binary(dv, yp[plan.te_idx], metric), mesh, perm_axes)


def sharded_problems(fn, xs: torch.Tensor, mesh, *,
                     problem_axes: tuple = ("pod", "data")):
    """Map ``fn`` over the problem axis of ``xs`` (Q, ...), Q sharded over
    the mesh's problem axes (those present in the mesh are used).

    The generic problem-axis decomposition (paper §4.2: searchlights, time
    points, RSA sweeps). Each rank runs its problems in turn (the
    hand-written kernels do not pass through ``torch.func.vmap``), stacks
    the outputs (``fn`` returns a tensor or a tuple of tensors) and gathers
    them: the only collective. Q must divide by the shard count.
    """
    axes = _present(mesh, problem_axes)
    _require_device(mesh, xs)
    index, shards = _shard(mesh, axes)
    q = xs.shape[0]
    if q % shards:
        raise ValueError(f"{q} problems do not divide over {shards} shards of {axes}")
    local = q // shards
    outs = [fn(x) for x in xs[index * local:(index + 1) * local]]
    if isinstance(outs[0], tuple):
        return tuple(_gather(torch.stack(part), mesh, axes) for part in zip(*outs))
    return _gather(torch.stack(outs), mesh, axes)


def searchlight_cv(xs: torch.Tensor, y: torch.Tensor, folds: Folds, lam: float, mesh, *,
                   problem_axes: tuple = ("pod", "data"),
                   adjust_bias: bool = True) -> torch.Tensor:
    """Many independent CV problems (searchlights, time points): ``xs``
    (Q, N, P_local) sharded over the problem axes, each problem a full
    analytical CV on its rank. Returns per-problem accuracy (Q,) in float32,
    the reference's mean of hits."""

    def one_problem(x):
        dv, y_te = fastcv.binary_cv(x, y, folds, lam=lam, adjust_bias=adjust_bias)
        pred = torch.where(dv >= 0, 1.0, -1.0).to(dv.dtype)
        hits = pred == torch.sign(y_te).to(dv.dtype)
        return metrics.share(hits.sum(), hits.numel())

    return sharded_problems(one_problem, xs, mesh, problem_axes=problem_axes)
