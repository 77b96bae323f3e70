"""Model assembly: embeddings → trunk → head; forward / prefill / decode.

The port of the reference's ``models/model.py`` for the attention, MoE and
RG-LRU trunks. ``init_params(cfg)`` builds the model as ``nn.Module``s whose
parameter names follow the reference's keys (``embed.tokens``,
``blocks.layers.<i>.attn.wq``, ``blocks.layers.<i>.moe.router``,
``blocks.layers.<i>.rglru.a_param``, ``final_norm.scale``, ``lm_head``),
from an explicit ``torch.Generator`` on the target device; ``forward``
(with the MoE load-balancing loss), ``prefill_step`` and ``decode_step``
(K/V caches and recurrent state, updated in place) are the serving
programs. Training (``loss_fn``, ``train_step``) waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = L._pdt(cfg)
        self.embed = nn.ParameterDict({"tokens": L.param((cfg.vocab_size, cfg.d_model), pdt,
                                                         device)})
        self.blocks = T.Trunk(cfg, device)
        self.final_norm = L.Norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.param((cfg.d_model, cfg.vocab_size), pdt, device))

    def init_(self, gen: torch.Generator) -> None:
        L.dense_init_(self.embed["tokens"], gen)
        self.blocks.init_(gen)
        self.final_norm.init_(gen)
        if self.lm_head is not None:
            L.dense_init_(self.lm_head, gen)


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator] = None,
                device=None) -> Model:
    """A randomly initialised model on ``device`` (None: cuda). Draws from
    ``generator`` (default: a generator on that device seeded 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    model = Model(cfg, dev)
    model.init_(generator)
    return model


def _embed(params: Model, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = L._dt(cfg)
    h = params.embed["tokens"][tokens].to(dt)
    if cfg.emb_scale is not None:
        h = h * torch.tensor(cfg.emb_scale, dtype=dt, device=h.device)
    return h


def _unembed(params: Model, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """h: (B, S, D) -> logits f32 (B, S, V)."""
    hf = L.apply_norm(params.final_norm, h, cfg).float()
    if cfg.tie_embeddings:
        logits = hf @ params.embed["tokens"].float().T
    else:
        logits = hf @ params.lm_head.float()
    # in place on the fresh logits: at a 256,000 vocabulary each copy is GBs
    if cfg.logit_scale is not None:
        logits.mul_(cfg.logit_scale)
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits.div_(c).tanh_().mul_(c)
    return logits


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int64, device=device)[None, :]


def forward(params: Model, tokens: torch.Tensor, cfg: ArchConfig, *,
            collect_cache: bool = False):
    """Full-sequence forward. Returns (logits, per-layer caches | None, aux):
    aux is the MoE load-balancing loss summed over the layers (0 without
    MoE)."""
    h = _embed(params, tokens, cfg)
    h, caches, aux = T.apply_trunk_full(params.blocks, h, cfg,
                                        positions=_positions(tokens.shape[-1], tokens.device),
                                        collect_cache=collect_cache)
    return _unembed(params, h, cfg), caches, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE per position. logits f32 (..., V); labels int (...,)."""
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    return lse - logits.gather(-1, labels[..., None].long())[..., 0]


def prefill_step(params: Model, batch: dict, cfg: ArchConfig):
    """Prefill: full forward returning last-position logits (B, V) + KV caches
    (one dict per layer, prefill length; None for an ``rglru`` layer, whose
    recurrent state the prefill does not return, as in the reference)."""
    logits, caches, _ = forward(params, batch["tokens"], cfg, collect_cache=True)
    return logits[:, -1].clone(), caches          # a copy: the full logits can go


def decode_step(params: Model, tokens: torch.Tensor, pos: int, caches: list, cfg: ArchConfig):
    """One-token decode. tokens: (B, 1); pos: absolute position of the new
    token. Returns (logits (B, 1, V), caches) — the caches (K/V slots, and
    the ``rglru`` layers' recurrent state) updated in place."""
    h = _embed(params, tokens, cfg)
    h, caches = T.apply_trunk_decode(params.blocks, h, cfg, pos=pos, caches=caches)
    return _unembed(params, h, cfg), caches


def count_params(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())
