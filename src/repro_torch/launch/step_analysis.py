"""Step counter: FLOPs, dot bytes and collective bytes of one eager step.

The counterpart of the reference's ``repro.launch.hlo_analysis``. The
reference parses a compiled program's HLO and multiplies each ``while``
body by its trip count, because XLA's cost analysis counts a loop body
once. The port has no program text: :func:`analyze_step` runs the step
eagerly under a ``TorchDispatchMode`` and counts every op as it executes,
so each loop iteration (a layer, an sLSTM position, a recomputed forward
under remat) is counted as often as it runs. It accumulates:

  * dot FLOPs:     2 · prod(result shape) · contracted extent, for every
                   ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (what an
                   einsum, ``@`` or ``F.linear`` lowers to)
  * dot HBM bytes: lhs + rhs + out bytes per dot (the reference's
                   perfect-fusion lower bound for the memory term)
  * collective bytes per kind, result-shape convention, from the
    ``_c10d_functional`` ops DTensor issues (all-reduce, all-gather,
    reduce-scatter, all-to-all)

with the reference's keys (:data:`COLLECTIVE_OPS` names included).

**Per rank.** Under a mesh the step's tensors are DTensors. The mode
declines every op that has a DTensor argument (returns
``NotImplemented``), so DTensor runs the op and the mode sees what one rank
executes: the local op on the rank's shard and the collectives of any
redistribution, each at its local shape. DTensor also runs each op once on
global-shaped stand-ins to infer its output's metadata; those runs are not
work and are not counted (:func:`_skip_propagation`). The fake process
group runs rank 0, whose shards are the largest where a dim splits
unevenly.

**Attention on the card.** The flash kernel is a ctypes launch whose
work no dispatch mode sees, but the launch is an operator
(``repro_torch::flash_attention``), which the counter sees by name. It
counts one launch as what the plain version (``attention_ref``) counts on
the CPU: its two full S × S products (scores and values), masked or not,
with their f32 operand bytes. The backward recomputes ``attention_ref``
outside every mode and shows the counter only its gradient products, so
a step counts the same on the card as on the CPU. Beside the counts,
``flash`` keeps the launches, the bytes they add to ``dot_hbm_bytes`` and
the bytes the kernel moves (q, k, v and the output, once each, in their
own dtype): a roofline of the card's step takes the latter.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

__all__ = ["analyze_step", "StepCounter", "COLLECTIVE_OPS"]

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default}

#: The flash launch's operator, ``repro_torch::flash_attention``.
_FLASH = "flash_attention"

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """The counting mode. ``flops``, ``dot_hbm_bytes``,
    ``collective_bytes`` / ``collective_counts`` (by kind) accumulate over
    every op run under it; :meth:`result` gives the reference's dict.
    ``flash`` tallies the flash operator's launches (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_hbm_bytes = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVE_OPS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.flash = {"launches": 0, "ref_bytes": 0, "kernel_bytes": 0}

    def add_dot(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.dot_hbm_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it; its local ops come back here
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            a, b = args[-2], args[-1]
            k = a.shape[-1]
            self.add_dot(2 * out.numel() * k, _nbytes(a) + _nbytes(b) + _nbytes(out))
        elif func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None:
                self.collective_bytes[kind] += sum(_nbytes(t) for t in _tensors(out))
                self.collective_counts[kind] += 1
        elif func.namespace == "repro_torch" and func._overloadpacket.__name__ == _FLASH:
            self._add_flash(*args[:3], out)
        return out

    def _add_flash(self, q, k, v, out) -> None:
        """One flash launch (q (B, Hq, S, D), k / v (B, Hkv, S_kv, D)) as
        ``attention_ref``'s two products: scores (B·Hq, S, D) · (D, S_kv)
        and values (B·Hq, S, S_kv) · (S_kv, D), f32 operands."""
        b, hq, s, d = q.shape
        hkv, s_kv = k.shape[1], k.shape[2]
        f32 = 4
        scores = (2 * b * hq * s * s_kv * d,
                  f32 * (b * hq * s * d + b * hkv * s_kv * d + b * hq * s * s_kv))
        values = (2 * b * hq * s * s_kv * d,
                  f32 * (b * hq * s * s_kv + b * hkv * s_kv * d + b * hq * s * d))
        for flops, nbytes in (scores, values):
            self.add_dot(flops, nbytes)
        self.flash["launches"] += 1
        self.flash["ref_bytes"] += scores[1] + values[1]
        self.flash["kernel_bytes"] += sum(_nbytes(t) for t in (q, k, v, out))

    def result(self) -> dict:
        return {
            "flops": self.flops,
            "dot_hbm_bytes": self.dot_hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_total_bytes": sum(self.collective_bytes.values()),
        }


@contextlib.contextmanager
def _skip_propagation():
    """Run DTensor's output-metadata inference (one run of each new op
    signature on global-shaped fake stand-ins) outside every dispatch mode,
    so the counter does not see its stand-ins."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("this torch's ShardingPropagator has no tensor-meta propagation "
                           "method the step counter knows")
    original = getattr(ShardingPropagator, name)

    def wrapped(self, *args, **kwargs):
        with _disable_current_modes():
            return original(self, *args, **kwargs)

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


def analyze_step(fn, *args, mesh=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count it. Returns the keys of
    the reference's ``analyze_hlo`` (``flops``, ``dot_hbm_bytes``,
    ``collective_bytes``, ``collective_counts``, ``collective_total_bytes``),
    per rank, ``flash`` (the counter's tally of flash launches) and
    ``output``, what ``fn`` returned.

    With ``mesh`` (the DeviceMesh the step's DTensors live on) plain
    tensors that meet a DTensor count as replicated on it
    (``implicit_replication``), as the reference's jit treats constants.
    """
    counter = StepCounter()
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            from torch.distributed.tensor.experimental import implicit_replication

            stack.enter_context(_skip_propagation())
            stack.enter_context(implicit_replication())
        stack.enter_context(counter)
        out = fn(*args, **kwargs)
    return dict(counter.result(), flash=dict(counter.flash), output=out)

