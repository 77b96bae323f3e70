"""AdamW with bf16-parameter / f32-master mixed precision, LR schedules
(cosine and MiniCPM's WSD), global-norm clipping and optional int8
error-feedback gradient compression.

The port of the reference's ``optim/optimizer.py``. The state mirrors the
model's parameters by name (``OptState.master`` / ``mu`` / ``nu`` / ``err``
keyed like ``model.named_parameters()``), and the step is a 0-dim int32
tensor. The arithmetic follows the reference operation for operation, with
the schedule, the learning rate and the bias corrections computed in f32
from an f32 step. Unlike the reference, which computes new parameters and
state functionally, :func:`apply_updates` updates them in place, tensor by
tensor: at gemma2-2b a second copy of the f32 master and moments (31 GB),
or the whole gradient in f32 (10.5 GB), would not fit beside them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.optim import compression

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates", "wsd_schedule",
           "cosine_schedule", "learning_rate"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: fraction of steps in decay phase
    compress_grads: bool = False      # int8 error-feedback DP compression


def _step_tensor(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.tensor(step, dtype=torch.int32)


def _warm(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    return torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)


def cosine_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then a half cosine to 0 at ``total_steps``; f32 ()."""
    step = _step_tensor(step)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr_peak * _warm(step, cfg) * (0.5 * (1.0 + torch.cos(math.pi * t)))


def wsd_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395 §4): linear warmup,
    long stable plateau at peak LR, short exponential-ish decay tail; f32 ()."""
    step = _step_tensor(step)
    decay_steps = int(cfg.total_steps * cfg.decay_frac)
    decay_start = cfg.total_steps - decay_steps
    in_decay = torch.clamp((step - decay_start).float() / max(decay_steps, 1), 0.0, 1.0)
    decay = torch.where(step >= decay_start,
                        0.5 ** in_decay * 2.0 * 0.5 ** (3.0 * in_decay),
                        torch.ones((), device=step.device))
    return cfg.lr_peak * _warm(step, cfg) * torch.clamp(decay, max=1.0)


def learning_rate(step, cfg: AdamWConfig) -> torch.Tensor:
    """The schedule's learning rate at ``step`` (an int or an int tensor); f32 ()."""
    if cfg.schedule == "wsd":
        return wsd_schedule(step, cfg)
    if cfg.schedule == "cosine":
        return cosine_schedule(step, cfg)
    return torch.tensor(cfg.lr_peak, dtype=torch.float32, device=_step_tensor(step).device)


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    master: dict             # f32 master params
    mu: dict                 # first moment (f32)
    nu: dict                 # second moment (f32)
    err: Optional[dict]      # compression error feedback (f32) or None


@torch.no_grad()
def init_opt_state(params: dict, cfg: AdamWConfig) -> OptState:
    """Zero moments and an f32 master copy (never aliasing ``params``) of the
    named tensors ``params``, on their device."""
    first = next(iter(params.values()))
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master={n: p.detach().to(torch.float32, copy=True) for n, p in params.items()},
        mu=zeros,
        nu={n: torch.zeros_like(z) for n, z in zeros.items()},
        err={n: torch.zeros_like(z) for n, z in zeros.items()} if cfg.compress_grads else None,
    )


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: OptState, cfg: AdamWConfig,
                  groups: Optional[list] = None) -> dict:
    """One AdamW step, in place on ``params`` (cast from the new master) and
    ``state``. ``grads`` holds a gradient per name of ``params``, in any
    float dtype; ``groups`` (lists of names) are the tensors that share one
    compression scale (None: each alone). Returns {"grad_norm", "lr"} (f32
    () tensors).

    Two passes, tensor by tensor: the first takes each gradient in f32
    (through the int8 round trip with compression, group by group, updating
    ``err`` and keeping the codes) and sums its squares; the second scales
    it by the clip factor and updates the moments, the master and the
    parameter.
    """
    codes = {}
    sq = torch.zeros((), dtype=torch.float32, device=state.step.device)
    for names in [[n] for n in grads] if groups is None else groups:
        g32s = [grads[n].float() for n in names]
        if cfg.compress_grads:
            qs, scale, errs = compression.compress_group(g32s, [state.err[n] for n in names])
            for n, q, e in zip(names, qs, errs):
                codes[n] = (q, scale)
                state.err[n].copy_(e)
            del errs
            g32s = [compression.dequantize_int8(q, scale) for q in qs]
        for g in g32s:
            sq = sq + torch.sum(g * g)
        del g32s
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state.step + 1
    lr = learning_rate(step, cfg)
    step_f = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, step_f)
    b2c = 1.0 - torch.pow(cfg.b2, step_f)
    for name, g in grads.items():
        g32 = (compression.dequantize_int8(*codes.pop(name)) if cfg.compress_grads
               else g.float())
        g32 = g32 * scale
        mu, nu, w = state.mu[name], state.nu[name], state.master[name]
        # the reference's expressions, operation for operation, through two
        # temporaries: t and u are reused where it writes a new array
        t = torch.mul(g32, 1 - cfg.b1)
        mu.mul_(cfg.b1).add_(t)                         # b1·m + (1−b1)·g
        torch.mul(g32, 1 - cfg.b2, out=t).mul_(g32)
        nu.mul_(cfg.b2).add_(t)                         # b2·v + (1−b2)·g·g
        del g32
        u = torch.div(mu, b1c)
        torch.div(nu, b2c, out=t).sqrt_().add_(cfg.eps)
        u.div_(t)                                       # (m/b1c) / (sqrt(v/b2c) + eps)
        u.add_(torch.mul(w, cfg.weight_decay, out=t)).mul_(lr)
        w.sub_(u)                                       # w − lr·(update + wd·w)
        del t, u
        params[name].copy_(w)
    state.step.copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
