"""The reference's parameter pytree → the port's model.

The reference stores each pattern position's block parameters stacked
over repeats (a leading repeat axis) under ``blocks.stack``, the layers
beyond the last full repeat under ``blocks.tail``, and an untied head as
``lm_head``. :func:`params_from_jax` takes that tree as nested dicts and
lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.model.Model` holding the same numbers, block
``r·len(pattern) + i`` taken from repeat r of stack entry i. A block's
subtrees keep their keys (``attn.*``, ``mlp.*``, ``moe.*``, ``rglru.*``),
stacked or in the tail alike.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import _pattern_split


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = np.asarray(val)
    return out


def params_from_jax(tree: dict, cfg: ArchConfig, *, device=None) -> Model:
    """The port's model with the reference's parameters (``device`` None: cuda).

    Every parameter of the model must be given and every array used, with
    the model's shape; anything else raises ``ValueError``.
    """
    dev = resolve_device(device)
    pat, n_rep, _ = _pattern_split(cfg)
    flat = _flatten({k: v for k, v in tree.items() if k != "blocks"}, "", {})
    for i, stacked in enumerate(tree["blocks"]["stack"]):
        for name, arr in _flatten(stacked, "", {}).items():
            if arr.shape[0] != n_rep:
                raise ValueError(f"stack[{i}].{name}: leading axis {arr.shape[0]} != {n_rep} "
                                 "repeats")
            for r in range(n_rep):
                flat[f"blocks.layers.{r * len(pat) + i}.{name}"] = arr[r]
    for j, blk in enumerate(tree["blocks"]["tail"]):
        _flatten(blk, f"blocks.layers.{n_rep * len(pat) + j}.", flat)

    model = Model(cfg, dev)
    named = dict(model.named_parameters())
    if set(named) != set(flat):
        raise ValueError(f"parameter names differ: missing {sorted(set(named) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(named))}")
    for name, p in named.items():
        arr = flat[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model
