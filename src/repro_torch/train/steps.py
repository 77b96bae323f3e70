"""The training and serving step functions.

The port of the reference's ``train/steps.py``. The reference's steps are
pure functions that its launcher jits; here they run eagerly and the train
step updates the model and the optimizer state in place
(``optim.optimizer.apply_updates``).

The gradient of one batch is ``torch.autograd.grad`` of ``loss_fn`` over
every parameter, in the parameters' dtype (bf16 at the full configs), as
the reference's ``jax.value_and_grad`` gives it. With ``microbatches`` = µ
> 1 the batch is split along its leading axis and each µ-batch's gradient
is summed into buffers of ``accum_dtype`` (f32), never into ``.grad``
(which accumulates in the parameter's dtype), then divided by µ.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as O

__all__ = ["init_train_state", "make_train_step", "make_prefill_step", "make_decode_step",
           "trainable", "loss_and_grads"]


def trainable(params: M.Model) -> dict:
    """The model's parameters by name, in ``named_parameters`` order."""
    return dict(params.named_parameters())


def init_train_state(cfg: ArchConfig, opt_cfg: O.AdamWConfig, *,
                     generator: Optional[torch.Generator] = None, device=None):
    """A randomly initialised model whose parameters require grad, and its
    optimizer state. ``device`` None: cuda."""
    params = M.init_params(cfg, generator=generator, device=device)
    params.requires_grad_(True)
    return params, O.init_opt_state(trainable(params), opt_cfg)


def _grads(loss: torch.Tensor, named: dict) -> list:
    """d loss / d each tensor of ``named``; zeros for one the loss does not reach."""
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, named.values())]


def _like(g: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its optimizer state (ZeRO-1: reduced
    and scattered over the data axes); a plain tensor as it is."""
    if hasattr(g, "placements") and hasattr(state, "placements"):
        return g.redistribute(state.device_mesh, state.placements)
    return g


def _microbatch(batch: dict, microbatches: int, i: int) -> dict:
    """Rows [i·b/µ, (i+1)·b/µ) of every tensor of ``batch``. A DTensor is
    split per rank, as data-parallel µ-batching splits it: µ-batch i holds
    rows [i·b_r/µ, (i+1)·b_r/µ) of each rank's b_r rows, laid out as the
    batch was. The µ-batches hold other rows than the plain split's, and
    the mean over them is the batch's mean all the same."""
    def part(x):
        if hasattr(x, "placements"):
            from torch.distributed.tensor import DTensor

            local = x.to_local()
            b = local.shape[0] // microbatches
            return DTensor.from_local(local[i * b:(i + 1) * b], x.device_mesh, x.placements,
                                      run_check=False)
        b = x.shape[0] // microbatches
        return x[i * b:(i + 1) * b]

    return {k: part(v) for k, v in batch.items()}


def loss_and_grads(params: M.Model, batch: dict, cfg: ArchConfig, microbatches: int = 1,
                   accum_dtype: torch.dtype = torch.float32):
    """(loss, {"ce", "aux"}, {name: gradient}) of one batch, µ-batched as the
    module docstring says. The loss and metrics are detached f32 () tensors."""
    named = trainable(params)
    with torch.enable_grad():
        if microbatches == 1:
            loss, metrics = M.loss_fn(params, batch, cfg)
            grads = dict(zip(named, _grads(loss, named)))
            return (loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads)
        acc = {n: torch.zeros_like(p, dtype=accum_dtype, memory_format=torch.contiguous_format)
               for n, p in named.items()}
        loss_sum = aux_sum = 0.0
        for i in range(microbatches):
            loss, metrics = M.loss_fn(params, _microbatch(batch, microbatches, i), cfg)
            for a, g in zip(acc.values(), _grads(loss, named)):
                a.add_(g.to(accum_dtype))
            loss_sum = loss_sum + loss.detach()
            aux_sum = aux_sum + metrics["aux"].detach()
            del loss, metrics
    grads = {n: a.float() / microbatches for n, a in acc.items()}
    loss = loss_sum / microbatches
    return loss, {"ce": loss - aux_sum / microbatches, "aux": aux_sum / microbatches}, grads


def make_train_step(cfg: ArchConfig, opt_cfg: O.AdamWConfig, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """``train_step(params, opt_state, batch, *, skip_nonfinite=False) ->
    metrics``: one AdamW step on ``batch``, in place. metrics: ``loss``,
    ``ce``, ``aux``, ``grad_norm`` and ``lr`` (f32 () tensors).

    With ``skip_nonfinite`` the loss is read before the update (a host
    sync); a loss that is not finite leaves the parameters and ``opt_state``
    untouched, and the metrics hold ``loss``, ``ce``, ``aux`` and
    ``skipped`` = True. Gradient compression scales the tensors the reference
    stacks together with one scale (``transformer.stacked_groups``).
    """
    groups = T.stacked_groups([n for n, _ in M.Model(cfg, "meta").named_parameters()], cfg)

    def train_step(params: M.Model, opt_state: O.OptState, batch: dict, *,
                   skip_nonfinite: bool = False) -> dict:
        loss, metrics, grads = loss_and_grads(params, batch, cfg, microbatches, accum_dtype)
        grads = {n: _like(g, opt_state.master[n]) for n, g in grads.items()}
        if skip_nonfinite and not math.isfinite(float(loss)):
            return dict(metrics, loss=loss, skipped=True)
        stats = O.apply_updates(trainable(params), grads, opt_state, opt_cfg,
                                groups=groups)
        return dict(metrics, loss=loss, **stats)

    return train_step


def make_prefill_step(cfg: ArchConfig, microbatches: int = 1) -> Callable:
    """Prefill, optionally over µ batch chunks (transient activation memory
    scales 1/µ). Returns (last logits, caches); with µ > 1 the caches stay
    per chunk (a list of µ per-layer lists), as the reference keeps a
    leading (µ,) axis, and the last logits are concatenated. Runs under
    ``torch.no_grad()``, as does the decode step."""
    if microbatches == 1:
        @torch.no_grad()
        def prefill_step(params, batch):
            return M.prefill_step(params, batch, cfg)
        return prefill_step

    @torch.no_grad()
    def prefill_step(params, batch):
        lasts, caches = [], []
        for i in range(microbatches):
            last, cache = M.prefill_step(params, _microbatch(batch, microbatches, i), cfg)
            lasts.append(last)
            caches.append(cache)
        return torch.cat(lasts), caches

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    @torch.no_grad()
    def decode_step(params, tokens, pos, caches):
        return M.decode_step(params, tokens, pos, caches, cfg)

    return decode_step
