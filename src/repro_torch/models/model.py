"""Model assembly: embeddings → trunk → head; forward / prefill / decode.

The port of the reference's ``models/model.py``. ``init_params(cfg)``
builds the model as ``nn.Module``s whose parameter names follow the
reference's keys (``embed.tokens``, ``blocks.layers.<i>.attn.wq``,
``blocks.layers.<i>.moe.router``, ``blocks.layers.<i>.rglru.a_param``,
``blocks.layers.<i>.mlstm.w_up``, ``blocks.layers.<i>.gate_attn``,
``final_norm.scale``, ``lm_head``), from an explicit ``torch.Generator`` on
the target device; ``forward`` (with the MoE load-balancing loss),
``prefill_step`` and ``decode_step`` (K/V caches and recurrent state,
updated in place) are the serving programs; ``loss_fn`` is the training
objective (``repro_torch.train.steps`` differentiates it).

Modality stubs, as in the reference: [vlm] takes precomputed patch
embeddings (B, vision_tokens, vision_dim) through a linear projector
(``vision_proj.w``) feeding the cross-attention layers; [audio] sums
``num_codebooks`` token embeddings (``embed.codebook_<i>``, tokens (B, K, S))
and predicts each codebook with its own head (``lm_head_<i>``, logits
(B, S, K, V)).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.sharding import constrain, embedding_table
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = L._pdt(cfg)
        names = ([f"codebook_{i}" for i in range(cfg.num_codebooks)] if cfg.num_codebooks
                 else ["tokens"])
        self.embed = nn.ParameterDict({name: L.param((cfg.vocab_size, cfg.d_model), pdt, device)
                                       for name in names})
        self.vision_proj = (nn.ParameterDict({"w": L.param((cfg.vision_dim, cfg.d_model), pdt,
                                                           device)})
                            if cfg.vision_tokens else None)
        self.blocks = T.Trunk(cfg, device)
        self.final_norm = L.Norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings or cfg.num_codebooks
                        else L.param((cfg.d_model, cfg.vocab_size), pdt, device))
        for i in range(cfg.num_codebooks):
            setattr(self, f"lm_head_{i}", L.param((cfg.d_model, cfg.vocab_size), pdt, device))

    def heads(self) -> list:
        """The per-codebook heads ``lm_head_<i>`` in order ([] without codebooks)."""
        return [getattr(self, f"lm_head_{i}") for i in range(self.cfg.num_codebooks)]

    def init_(self, gen: torch.Generator) -> None:
        for table in self.embed.values():
            L.dense_init_(table, gen)
        if self.vision_proj is not None:
            L.dense_init_(self.vision_proj["w"], gen)
        self.blocks.init_(gen)
        self.final_norm.init_(gen)
        for w in [self.lm_head] + self.heads():
            if w is not None:
                L.dense_init_(w, gen)


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


def _embed(params: Model, tokens: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), or (B, K, S) with codebooks (their embeddings summed in
    the param dtype, in codebook order) -> (B, S, D) in the compute dtype;
    sinusoidal position embeddings added after ``emb_scale``. The rows are
    looked up by ``F.embedding``, which DTensor shards over the vocabulary
    (an indexing of the table it does not, on every torch the port runs)."""
    dt = L._dt(cfg)
    if cfg.num_codebooks:
        h = sum(F.embedding(tokens[:, i], embedding_table(params.embed[f"codebook_{i}"]))
                for i in range(cfg.num_codebooks)).to(dt)
    else:
        h = F.embedding(tokens, embedding_table(params.embed["tokens"])).to(dt)
    h = constrain(h, ("batch_unembed", "seq", "embed"))
    if cfg.emb_scale is not None:
        h = h * torch.tensor(cfg.emb_scale, dtype=dt, device=h.device)
    if cfg.pos_embedding == "sinusoidal":
        h = h + L.sinusoidal(positions, cfg.d_model).to(dt)
    return constrain(h, ("batch", "seq", "embed"))


def _unembed(params: Model, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """h: (B, S, D) -> logits f32 (B, S, V), or (B, S, K, V) with codebooks."""
    hf = constrain(L.apply_norm(params.final_norm, h, cfg).float(),
                   ("batch_unembed", "seq", "embed"))
    if cfg.num_codebooks:
        logits = torch.stack([hf @ w.float() for w in params.heads()], dim=2)
    elif cfg.tie_embeddings:
        logits = hf @ params.embed["tokens"].float().T
    else:
        logits = hf @ params.lm_head.float()
    if cfg.logit_scale is not None:
        logits = L.scale_(logits, cfg.logit_scale)
    if cfg.final_logit_softcap is not None:
        logits = L.softcap_(logits, cfg.final_logit_softcap)
    return logits if cfg.num_codebooks else constrain(logits, ("batch", "seq", "vocab"))


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int64, device=device)[None, :]


def _vision_kv(params: Model, vision_embeds: Optional[torch.Tensor],
               cfg: ArchConfig) -> Optional[torch.Tensor]:
    """Patch embeddings (B, S_vis, vision_dim) -> (B, S_vis, D) in the compute
    dtype, the cross layers' key/value source (None stays None)."""
    if vision_embeds is None:
        return None
    w = params.vision_proj["w"].to(L._dt(cfg))
    return vision_embeds.to(w.dtype) @ w


def forward(params: Model, tokens: torch.Tensor, cfg: ArchConfig, *,
            vision_embeds: Optional[torch.Tensor] = None, collect_cache: bool = False):
    """Full-sequence forward. Returns (logits, per-layer caches | None, aux):
    aux is the MoE load-balancing loss summed over the layers (0 without
    MoE)."""
    positions = _positions(tokens.shape[-1], tokens.device)
    h = _embed(params, tokens, cfg, positions)
    h, caches, aux = T.apply_trunk_full(params.blocks, h, cfg, positions=positions,
                                        vis_kv=_vision_kv(params, vision_embeds, cfg),
                                        collect_cache=collect_cache)
    return _unembed(params, h, cfg), caches, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE per position. logits f32 (..., V); labels int (...,). The label's
    logit is gathered from the (positions, V) view: DTensor gathers from a
    vocab-sharded 2-D view, not from the 3-D one."""
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    picked = logits.reshape(-1, logits.shape[-1]).gather(1, labels.reshape(-1, 1).long())
    return lse - picked.reshape(labels.shape)


def loss_fn(params: Model, batch: dict, cfg: ArchConfig):
    """Mean next-token CE plus the MoE aux loss. batch: ``tokens`` /
    ``labels`` (B, S), or (B, K, S) with codebooks (labels transposed to
    (B, S, K) against the (B, S, K, V) logits), and ``vision_embeds`` for a
    vision model. Returns (loss, {"ce", "aux"})."""
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             vision_embeds=batch.get("vision_embeds"))
    labels = batch["labels"]
    if cfg.num_codebooks:
        labels = labels.transpose(1, 2)                  # (B, K, S) -> (B, S, K)
    ce = cross_entropy(logits, labels).mean()
    return ce + aux, {"ce": ce, "aux": aux}


def prefill_step(params: Model, batch: dict, cfg: ArchConfig):
    """Prefill: full forward over ``batch["tokens"]`` (with
    ``batch["vision_embeds"]`` when given) returning last-position logits
    (B, V), or (B, K, V) with codebooks, + KV caches (one dict per layer,
    prefill length; a cross layer's hold the vision K/V; None for an
    ``rglru``, ``mlstm`` or ``slstm`` layer, whose recurrent state the
    prefill does not return, as in the reference)."""
    logits, caches, _ = forward(params, batch["tokens"], cfg,
                                vision_embeds=batch.get("vision_embeds"), collect_cache=True)
    return logits[:, -1].clone(), caches          # a copy: the full logits can go


def decode_step(params: Model, tokens: torch.Tensor, pos: int, caches: list, cfg: ArchConfig,
                *, vision_embeds: Optional[torch.Tensor] = None):
    """One-token decode. tokens: (B, 1), or (B, K, 1) with codebooks; pos:
    absolute position of the new token. Returns (logits (B, 1, V) or
    (B, 1, K, V), caches) — the caches (K/V slots, and the recurrent layers'
    state) updated in place. ``vision_embeds`` is ignored, as in the
    reference: the cross layers read the vision K/V from their caches."""
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int64, device=tokens.device)
    h = _embed(params, tokens, cfg, positions)
    h, caches = T.apply_trunk_decode(params.blocks, h, cfg, pos=pos, caches=caches)
    return _unembed(params, h, cfg), caches


def count_params(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())
