"""Batched serving launcher: prefill, then greedy decode, on the LLM substrate.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 32 --gen-len 32 [--kv-quant] [--smoke]

Prefills a batch of random prompts (the flash_attention kernel on the
card), places the prefill K/V into caches of ``prompt_len + gen_len``
capacity (int8 with ``--kv-quant``), then steps the decode loop with greedy
sampling; reports tokens/s and the cache footprint. The full configuration
runs by default, on the card; ``--smoke`` takes the reduced one and
``--device cpu`` the plain versions on the CPU.

A prompt longer than a local layer's window is refused: the caches of
local layers hold ``min(local_window, total_len)`` slots, and placing a
longer prompt would need the ring-buffer layout of the last window's
positions. (The reference's launcher grafts such a prompt into no slot at
all, and its local layers then decode without the prompt.)

An architecture with ``rglru``, ``mlstm`` or ``slstm`` layers
(recurrentgemma, xlstm) is refused too: its prefill returns no recurrent
state, so decode could not continue from the prompt. (The reference's
launcher fails on the same gap.) Its forward, ``prefill_step`` and
``decode_step`` from an empty state all run.

The modality stubs serve as in the reference: a vision model takes
``vision_embeds`` (B, vision_tokens, vision_dim) beside its prompts, and
its cross layers' caches hold their K/V; an audio model takes prompts
(B, K, S) over its K codebooks and decodes greedily from codebook 0's
position, (B, K, 1) tokens a step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def check_prefill_state(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` if prefill leaves a layer without decode state."""
    kinds = [k for k in RECURRENT_KINDS if k in cfg.layer_kinds]
    if kinds:
        raise ValueError(f"{cfg.name}: prefill returns no recurrent state for its "
                         f"{'/'.join(kinds)} layers, so decode cannot continue from the prompt")


def check_prompt_len(cfg: ArchConfig, prompt_len: int) -> None:
    """Raise ``ValueError`` if a local layer's window is shorter than the prompt."""
    if "local" in cfg.layer_kinds and cfg.local_window is not None \
            and prompt_len > cfg.local_window:
        raise ValueError(f"{cfg.name}: prompt_len {prompt_len} > local_window "
                         f"{cfg.local_window}; the local layers' caches cannot hold the prompt")


def place_prefill(cfg: ArchConfig, prefill_caches: list, batch: int, total_len: int) -> list:
    """Caches of ``total_len`` capacity with the prefill K/V in slots 0 .. S−1
    (a cross layer's vision K/V in its ``vision_tokens`` slots)."""
    device = prefill_caches[0]["k"].device
    caches = T.init_trunk_cache(cfg, batch, total_len, device)
    for full, part in zip(caches, prefill_caches):
        for name, t in part.items():
            full[name][:, :t.shape[1]] = t
    return caches


@torch.no_grad()
def generate(params: M.Model, prompts: torch.Tensor, gen_len: int, cfg: ArchConfig, *,
             vision_embeds: Optional[torch.Tensor] = None):
    """Prefill ``prompts`` (B, S), or (B, K, S) over K codebooks (with
    ``vision_embeds`` for the cross layers), then ``gen_len − 1`` greedy
    decode steps.

    Returns (tokens (B, gen_len) or (B, K, gen_len), stats): the first token
    comes from the prefill's last logits. stats holds the prefill and decode
    seconds, decode tokens/s (a step's K codebook tokens count as one) and
    the caches' bytes. Runs under ``torch.no_grad()``: a model whose
    parameters require grad builds no graph here.
    """
    b, s = prompts.shape[0], prompts.shape[-1]
    check_prefill_state(cfg)
    check_prompt_len(cfg, s)
    dev = prompts.device
    batch = {"tokens": prompts}
    if vision_embeds is not None:
        batch["vision_embeds"] = vision_embeds
    _sync(dev)
    t0 = time.perf_counter()
    last, prefill_caches = M.prefill_step(params, batch, cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    caches = place_prefill(cfg, prefill_caches, b, s + gen_len)
    del prefill_caches

    tok = last.argmax(dim=-1)[..., None]              # (B, 1) or (B, K, 1)
    generated = [tok]
    t0 = time.perf_counter()
    for step in range(gen_len - 1):
        logits, caches = M.decode_step(params, tok, s + step, caches, cfg)
        tok = logits[:, 0].argmax(dim=-1)[..., None]
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    n_tok = b * (gen_len - 1)
    stats = {"prefill_s": t_prefill, "decode_s": t_decode, "decode_tokens": n_tok,
             "tokens_per_s": n_tok / max(t_decode, 1e-9),
             "cache_bytes": sum(t.numel() * t.element_size() for c in caches for t in c.values())}
    return torch.cat(generated, dim=-1), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    dev = resolve_device(args.device)
    check_prefill_state(cfg)
    check_prompt_len(cfg, args.prompt_len)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(cfg, generator=gen, device=dev)
    shape = (args.batch,) + ((cfg.num_codebooks,) if cfg.num_codebooks else ()) + \
        (args.prompt_len,)
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    vision = (torch.randn((args.batch, cfg.vision_tokens, cfg.vision_dim), generator=gen,
                          device=dev) if cfg.vision_tokens else None)
    out, st = generate(params, prompts, args.gen_len, cfg, vision_embeds=vision)
    print(f"[serve] {cfg.name} kv_quant={cfg.kv_quant} device={dev}")
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in {st['prefill_s']:.2f}s")
    print(f"[serve] decoded {st['decode_tokens']} tokens in {st['decode_s']:.2f}s "
          f"({st['tokens_per_s']:.1f} tok/s)")
    print(f"[serve] cache footprint: {st['cache_bytes'] / 2**20:.1f} MiB")
    print(f"[serve] sample output ids: {out.flatten()[:16].tolist()}")


if __name__ == "__main__":
    main()
