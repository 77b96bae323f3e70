"""Logical-axis sharding: rules mapping model tensors onto a device mesh.

The port of the reference's ``launch/sharding.py``: Megatron-style TP over
the "model" axis, DP over ("pod", "data"), optional sequence parallelism
(the residual stream sharded over "model" on the seq dim), expert
parallelism (experts over "model"), FSDP, and ZeRO-1 (optimizer state
additionally sharded over "data").

Where the reference keeps its rules in module globals that
``apply_profile`` / ``set_sequence_parallel`` / ``set_gathered_embed``
mutate, the port keeps them in a value: :func:`rules_for` returns a frozen
:class:`Rules`, and every function takes the rules it applies. The
functions return DTensor placements, one per mesh dim: ``Shard(d)`` where
the reference's ``PartitionSpec`` names that mesh axis on tensor dim d,
``Replicate()`` elsewhere. A tensor dim split over several axes (the
reference's ``("data", "model")``) is ``Shard(d)`` on each of them, the
first mesh dim major, as the reference's tuple orders them. A mesh is a
``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.MeshShape`: the rules
read only its dim names and sizes.

The port stores one tensor per layer (``blocks.layers.<i>.<name>``) where
the reference stacks a pattern position's layers over a leading repeat
axis. The rules match the same path suffixes, so a layer's placements are
the reference's spec for its stack entry with the repeat axis dropped.
Where the reference puts a mesh axis on the repeat axis itself (stacked
scalars such as a cross block's ``gate_attn`` under ZeRO-1), a layer's
tensor takes the spec the reference gives an unstacked (tail) layer.
FSDP's size threshold counts the elements the reference stores for the
tensor: the whole stack of its pattern position
(:func:`param_placements`).
"""

from __future__ import annotations

import dataclasses
import math
import re
import threading
from types import MappingProxyType
from typing import Mapping, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import MeshShape

__all__ = [
    "LOGICAL_RULES", "Rules", "rules_for", "DEFAULT_RULES", "axis_ctx", "constrain",
    "mesh_active",
    "embedding_table",
    "param_spec", "param_placements", "opt_state_spec", "opt_state_placements", "data_spec",
]

# logical axis -> mesh axis (None = replicate)
LOGICAL_RULES: Mapping[str, Optional[object]] = MappingProxyType({
    "batch": ("pod", "data"),
    "batch_dp": ("pod", "data"),   # always DP-only (MoE dispatch: "model" carries experts)
    "batch_unembed": ("pod", "data"),  # embed/unembed batch: matches the vocab-sharded
                                       # logits' batch axes
    "seq": None,              # "model" when sequence parallelism is on
    "embed": None,
    "heads": "model",
    "kv_heads": None,         # too few kv heads on most archs
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "rnn": "model",
    "vision_seq": None,
    "codebooks": None,
})

_PROFILES = {
    # megatron-style TP over "model" (baseline)
    "tp": {"heads": "model", "ffn": "model", "rnn": "model",
           "experts": "model", "vocab": "model",
           "batch": ("pod", "data")},
    # DP-heavy: weights replicated over "model" (ZeRO-1 still shards the
    # optimizer over "data"); vocab and experts stay sharded; the batch
    # shards over "model" too (full 256/512-way DP).
    "dp": {"heads": None, "ffn": None, "rnn": None,
           "experts": "model", "vocab": "model",
           "batch": ("pod", "data", "model")},
    # pure DP over (pod, data), the model axis idle except vocab/experts:
    # for tiny recurrent archs whose sequential scans would emit a
    # collective per step under any "model" sharding of the cell state.
    "dp16": {"heads": None, "ffn": None, "rnn": None,
             "experts": "model", "vocab": "model",
             "batch": ("pod", "data")},
    # FSDP: "dp"'s compute layout, with the weights stored fully sharded
    # over (data, model) and gathered at use.
    "fsdp": {"heads": None, "ffn": None, "rnn": None,
             "experts": "model", "vocab": "model",
             "batch": ("pod", "data", "model")},
}


@dataclasses.dataclass(frozen=True)
class Rules:
    """One sharding configuration: the logical-axis map and the switches.

    ``gathered_embed``: the embedding lookup replicates its vocab-sharded
    table first (one all-gather of the table per lookup) instead of
    reducing a masked (B, S, D) lookup over the vocab shards
    (:func:`embedding_table`)."""

    logical: Mapping[str, Optional[object]]
    profile: str = "tp"
    fsdp: bool = False
    sequence_parallel: bool = False
    gathered_embed: bool = False

    def as_dict(self) -> dict:
        """JSON-ready record of the rules (what a run logs)."""
        return {"profile": self.profile, "fsdp": self.fsdp,
                "sequence_parallel": self.sequence_parallel,
                "gathered_embed": self.gathered_embed,
                "logical": {k: (list(v) if isinstance(v, tuple) else v)
                            for k, v in self.logical.items()}}


def rules_for(profile: str = "tp", *, sequence_parallel: bool = False,
              gathered_embed: bool = False) -> Rules:
    """The rules of ``profile`` (``tp``, ``dp``, ``dp16`` or ``fsdp``), as
    the reference's ``apply_profile`` / ``set_sequence_parallel`` /
    ``set_gathered_embed`` leave its globals."""
    if profile not in _PROFILES:
        raise ValueError(f"unknown sharding profile {profile!r}; have {sorted(_PROFILES)}")
    logical = dict(LOGICAL_RULES)
    logical.update(_PROFILES[profile])
    logical["seq"] = "model" if sequence_parallel else None
    return Rules(MappingProxyType(logical), profile=profile, fsdp=profile == "fsdp",
                 sequence_parallel=sequence_parallel, gathered_embed=gathered_embed)


DEFAULT_RULES = rules_for("tp")


# ------------------------------------------------- specs <-> placements --

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _placements(spec, mesh) -> tuple:
    """Per-tensor-dim mesh axes (the reference's PartitionSpec entries) ->
    one placement per mesh dim. Axes the mesh lacks are dropped."""
    names = MeshShape.of(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = [a for a in _axes(entry) if a in names]
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"dim {d} splits over {axes}, not in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _spec(placements, ndim: int, mesh) -> list:
    """The inverse of :func:`_placements`: per tensor dim, the tuple of
    mesh axes that shard it (in mesh order)."""
    names = MeshShape.of(mesh).axis_names
    spec = [() for _ in range(ndim)]
    for a, p in zip(names, placements):
        if isinstance(p, Shard):
            spec[p.dim] = spec[p.dim] + (a,)
    return spec


def _size(axes, mesh) -> int:
    sizes = MeshShape.of(mesh).shape
    return math.prod(sizes[a] for a in axes)


# ------------------------------------------------------ active mesh ----

_state = threading.local()


class axis_ctx:
    """Context manager activating a mesh and rules for :func:`constrain`."""

    def __init__(self, mesh, rules: Rules = DEFAULT_RULES):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        _state.active = (self.mesh, self.rules)
        return self.mesh

    def __exit__(self, *exc):
        _state.active = None


def _resolve(logical_axes, mesh, rules: Rules = DEFAULT_RULES) -> tuple:
    """Placements of a tensor whose dims carry ``logical_axes``."""
    names = MeshShape.of(mesh).axis_names
    raw = []
    for ax in logical_axes:
        mesh_ax = rules.logical.get(ax) if ax is not None else None
        raw.append(tuple(a for a in _axes(mesh_ax) if a in names))
    # resolve duplicates: single-axis entries (e.g. vocab -> "model") claim
    # their axis first; multi-axis (batch) tuples drop already-claimed axes
    claimed = {a for axes in raw if len(axes) == 1 for a in axes}
    spec, seen = [], set()
    for axes in raw:
        if len(axes) > 1:
            axes = tuple(a for a in axes if a not in claimed and a not in seen)
        else:
            axes = tuple(a for a in axes if a not in seen)
        seen.update(axes)
        spec.append(axes)
    return _placements(spec, mesh)


def constrain(x: torch.Tensor, logical_axes) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' placements under the
    active :class:`axis_ctx`; no-op without a mesh or for a plain tensor.
    Unlike the reference's, it drops an axis that does not divide its dim
    (:func:`_sanitize`): DTensor cannot view an unevenly sharded dim."""
    active = getattr(_state, "active", None)
    if active is None or not hasattr(x, "placements"):
        return x
    mesh, rules = active
    return x.redistribute(mesh, _sanitize(_resolve(logical_axes, mesh, rules), x.shape, mesh))


def mesh_active(x: torch.Tensor) -> bool:
    """Whether :func:`constrain` acts on ``x``: a DTensor under an active
    :class:`axis_ctx`."""
    return getattr(_state, "active", None) is not None and hasattr(x, "placements")


def embedding_table(table: torch.Tensor) -> torch.Tensor:
    """The table an embedding lookup reads: replicated under an active
    :class:`axis_ctx` whose rules set ``gathered_embed``, else as it is."""
    active = getattr(_state, "active", None)
    if active is None or not active[1].gathered_embed:
        return table
    return constrain(table, (None, None))


# ---------------------------------------------------------------------------
# Parameter sharding rules: path-pattern -> logical axes per dimension. A
# port name's dots read as the reference's slashes
# (blocks.layers.3.attn.wq -> blocks/layers/3/attn/wq).
# ---------------------------------------------------------------------------

_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/tokens$", ("vocab", "embed")),
    (r"embed/codebook_\d+$", ("vocab", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    (r"lm_head_\d+$", ("embed", "vocab")),
    (r"vision_proj/w$", (None, "embed")),
    # attention
    (r"attn/wq$", ("embed", "heads", "head_dim")),
    (r"attn/wk$", ("embed", "kv_heads", "head_dim")),
    (r"attn/wv$", ("embed", "kv_heads", "head_dim")),
    (r"attn/wo$", ("heads", "head_dim", "embed")),
    (r"attn/(q_norm|k_norm)$", ("head_dim",)),
    # dense mlp
    (r"mlp/w_(gate|up)$", ("embed", "ffn")),
    (r"mlp/w_down$", ("ffn", "embed")),
    # moe: expert-parallel over "model" on the expert axis only
    (r"moe/router$", ("embed", None)),
    (r"moe/w_(gate|up)$", ("experts", None, None)),
    (r"moe/w_down$", ("experts", None, None)),
    # rg-lru
    (r"rglru/w_(x|gate)$", ("embed", "rnn")),
    (r"rglru/w_out$", ("rnn", "embed")),
    (r"rglru/(conv_w)$", (None, "rnn")),
    (r"rglru/(conv_b|a_param|w_a_b|w_x_b)$", ("rnn",)),
    (r"rglru/w_a$", ("rnn",)),
    (r"rglru/w_input_gate$", ("rnn",)),
    # xlstm
    (r"(mlstm|slstm)/w_(up|ffgate)$", ("embed", "ffn")),
    (r"(mlstm|slstm)/w_down$", ("ffn", "embed")),
    (r"(mlstm|slstm)/w_(q|k|v|i|f|o|zg)$", ("embed", "ffn")),
    (r"(mlstm|slstm)/r_(i|f|z|o)$", (None, "ffn", None)),
    (r"(mlstm|slstm)/conv_w$", (None, "ffn")),
    (r"(mlstm|slstm)/(conv_b|b_.*|skip_scale)$", ("ffn",)),
    (r"(mlstm|slstm)/gn$", ("ffn",)),
]


def param_spec(path: str, ndim: int, mesh, rules: Rules = DEFAULT_RULES) -> tuple:
    """Placements of a parameter given its name (dots or slashes) and rank,
    before :func:`_sanitize`. Norms, biases and gates replicate."""
    path = path.replace(".", "/")
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            axes = tuple(axes)
            if ndim == len(axes) + 1:          # a leading stack dim
                axes = (None,) + axes
            axes = axes[:ndim] + (None,) * (ndim - len(axes))
            return _placements([rules.logical.get(a) if isinstance(a, str) else None
                                for a in axes], mesh)
    return _placements([None] * ndim, mesh)


def _sanitize(placements, shape, mesh) -> tuple:
    """Drop mesh axes that do not divide the corresponding dim evenly."""
    spec = _spec(placements, len(shape), mesh)
    return _placements([axes if shape[d] % _size(axes, mesh) == 0 else ()
                        for d, axes in enumerate(spec)], mesh)


def _largest_free_dim(spec: list, shape, size: int):
    """(dim, extent) of the largest still-replicated dim that ``size``
    divides, or (None, 0)."""
    best, best_dim = None, 0
    for d, have in enumerate(spec):
        if not have and shape[d] % size == 0 and shape[d] > best_dim:
            best, best_dim = d, shape[d]
    return best, best_dim


def _unused(spec: list, candidates, mesh) -> tuple:
    used = {a for axes in spec for a in axes}
    names = MeshShape.of(mesh).axis_names
    return tuple(a for a in candidates if a in names and a not in used)


def _fsdp_spec(placements, shape, mesh) -> tuple:
    """Shard the largest still-replicated dim over the unused DP axes."""
    spec = _spec(placements, len(shape), mesh)
    axes = _unused(spec, ("data", "model"), mesh)
    if not axes:
        return tuple(placements)
    best, best_dim = _largest_free_dim(spec, shape, _size(axes, mesh))
    if best is not None and best_dim >= _size(axes, mesh):
        spec[best] = axes
    return _placements(spec, mesh)


def opt_state_spec(path: str, ndim: int, shape, mesh, rules: Rules = DEFAULT_RULES) -> tuple:
    """ZeRO-1: the optimizer's master and moments take the parameter's
    placements plus an extra shard over the unused DP axes on the largest
    replicated dim."""
    spec = _spec(_sanitize(param_spec(path, ndim, mesh, rules), shape, mesh), ndim, mesh)
    for extra in (("data", "model"), ("data",)):
        axes = _unused(spec, extra, mesh)
        if not axes:
            continue
        best, _ = _largest_free_dim(spec, shape, _size(axes, mesh))
        if best is not None:
            spec[best] = axes
            return _placements(spec, mesh)
    return _placements(spec, mesh)


def _stored_numel(named_shapes: dict, cfg) -> dict:
    """{name: elements of the array the reference stores it in}: a layer's
    tensor counts its whole stack (``transformer.stacked_groups``)."""
    from repro_torch.models.transformer import stacked_groups

    out = {}
    for group in stacked_groups(list(named_shapes), cfg):
        for name in group:
            out[name] = len(group) * math.prod(named_shapes[name])
    return out


def param_placements(named_shapes: dict, mesh, rules: Rules = DEFAULT_RULES,
                     cfg=None) -> dict:
    """{name: placements} for a model's parameters ({name: shape}, e.g.
    from ``Model(cfg, "meta")``), as the reference's
    ``param_sharding_tree``: sanitized, and under FSDP the tensors whose
    stored array holds more than 2^16 elements sharded further (``cfg``
    gives the stacks; without it each tensor counts alone)."""
    numel = (_stored_numel(named_shapes, cfg) if cfg is not None
             else {n: math.prod(s) for n, s in named_shapes.items()})
    out = {}
    for name, shape in named_shapes.items():
        pl = _sanitize(param_spec(name, len(shape), mesh, rules), shape, mesh)
        if rules.fsdp and numel[name] > 1 << 16:
            pl = _fsdp_spec(pl, shape, mesh)
        out[name] = pl
    return out


def opt_state_placements(named_shapes: dict, mesh, rules: Rules = DEFAULT_RULES) -> dict:
    """{name: placements} of the optimizer's per-parameter f32 tensors."""
    return {name: opt_state_spec(name, len(shape), shape, mesh, rules)
            for name, shape in named_shapes.items()}


def data_spec(mesh, *logical_axes, rules: Rules = DEFAULT_RULES) -> tuple:
    """Placements of a data tensor whose dims carry ``logical_axes``."""
    return _resolve(logical_axes, mesh, rules)
