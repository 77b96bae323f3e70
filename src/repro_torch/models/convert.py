"""The reference's parameter pytree → the port's model.

The reference stores each pattern position's block parameters stacked
over repeats (a leading repeat axis) under ``blocks.stack``, the layers
beyond the last full repeat under ``blocks.tail``, and an untied head as
``lm_head``. :func:`params_from_jax` takes that tree as nested dicts and
lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.model.Model` holding the same numbers, block
``r·len(pattern) + i`` taken from repeat r of stack entry i. A block's
subtrees keep their keys (``attn.*``, ``mlp.*``, ``moe.*``, ``rglru.*``,
``mlstm.*``, ``slstm.*``), stacked or in the tail alike, and so do a cross
block's scalar gates (``gate_attn``, ``gate_mlp``: (n_rep,) in the stack,
() a block). The modality stubs' top-level names carry over as they are:
``embed.codebook_<i>``, ``lm_head_<i>`` and ``vision_proj.w``.

The same mapping (:func:`flat_from_jax`) carries any tree shaped like the
parameters across: a gradient, or the optimizer state's f32 master and
moments (:func:`tensors_from_jax`, :func:`opt_state_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import _pattern_split
from repro_torch.optim.optimizer import OptState


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = np.asarray(val)
    return out


def flat_from_jax(tree: dict, cfg: ArchConfig) -> dict:
    """{the port's parameter name: numpy array} of a tree shaped like the
    reference's parameters (the parameters themselves, a gradient, or one
    of the optimizer's moments). Every parameter of the model must be given
    and every array used, with the model's shape; anything else raises
    ``ValueError``."""
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

    shapes = {n: tuple(p.shape) for n, p in Model(cfg, "meta").named_parameters()}
    if set(shapes) != set(flat):
        raise ValueError(f"parameter names differ: missing {sorted(set(shapes) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(shapes))}")
    for name, shape in shapes.items():
        if tuple(flat[name].shape) != shape:
            raise ValueError(f"{name}: shape {flat[name].shape} != {shape}")
    return {name: flat[name] for name in shapes}           # the model's order


def tensors_from_jax(tree: dict, cfg: ArchConfig, *, device=None) -> dict:
    """{name: f32 tensor} on ``device`` (None: cuda) of a tree shaped like the
    reference's parameters: a gradient, or a moment of the optimizer state.
    Names and order are ``Model.named_parameters()``'s."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)
            for name, arr in flat_from_jax(tree, cfg).items()}


def opt_state_from_jax(state, cfg: ArchConfig, *, device=None) -> OptState:
    """The port's :class:`~repro_torch.optim.optimizer.OptState` holding the
    reference's ``OptState`` (step, f32 master, mu, nu and err, or None)."""
    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=dev),
        master=tensors_from_jax(state.master, cfg, device=dev),
        mu=tensors_from_jax(state.mu, cfg, device=dev),
        nu=tensors_from_jax(state.nu, cfg, device=dev),
        err=None if state.err is None else tensors_from_jax(state.err, cfg, device=dev))


def params_from_jax(tree: dict, cfg: ArchConfig, *, device=None) -> Model:
    """The port's model with the reference's parameters (``device`` None: cuda),
    checked as :func:`flat_from_jax` checks them."""
    flat = flat_from_jax(tree, cfg)
    model = Model(cfg, resolve_device(device))
    for name, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.array(flat[name], dtype=np.float32)))
    return model
