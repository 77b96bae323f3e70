"""Deterministic synthetic token pipeline for LM training.

The port of the reference's ``data/tokens.py``: a seeded, reproducible,
infinitely repeatable token source with the interface a production loader
has: global-batch iteration, per-process sharding (each data-parallel
group reads only its slice), a checkpointable cursor (resume from a step),
and modality stubs for the vision and audio architectures (precomputed
patch embeddings; codebook tokens).

Batches are drawn with numpy's ``default_rng((seed, step))`` exactly as the
reference draws them, so the two packages' batches are equal bit for bit;
here they come back as tensors on the stream's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["TokenStreamConfig", "TokenStream"]


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality stubs
    num_codebooks: int = 0            # [audio] musicgen: >0 => multi-codebook
    vision_tokens: int = 0            # [vlm] llama-vision: >0 => patch embeds
    vision_dim: int = 0


class TokenStream:
    """Seeded synthetic token batches with a checkpointable cursor.

    Tokens are a Zipf-ish mixture (realistic rank-frequency profile) drawn
    from a counter-based RNG keyed on (seed, step), so any shard of any step
    is reproducible in O(1). ``device`` None: cuda.
    """

    def __init__(self, cfg: TokenStreamConfig, step: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.step = step
        self.device = resolve_device(device)

    def checkpoint_state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @staticmethod
    def restore(cfg: TokenStreamConfig, state: dict,
                device: Optional[Union[str, torch.device]] = None) -> "TokenStream":
        if state["seed"] != cfg.seed:
            raise ValueError("data seed changed across restart")
        return TokenStream(cfg, step=int(state["step"]), device=device)

    def _batch_at(self, step: int, batch: int, seq_plus_one: bool) -> dict:
        """numpy arrays of one step, drawn as the reference draws them."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        s = cfg.seq_len + (1 if seq_plus_one else 0)
        # Zipf-like: exponential-rank sampling keeps a heavy head like text.
        u = rng.random((batch, s))
        ranks = (-np.log1p(-u * (1 - np.exp(-12.0))) / 12.0 * cfg.vocab_size)
        toks = np.clip(ranks.astype(np.int32), 0, cfg.vocab_size - 1)
        out = {"tokens": toks}
        if cfg.num_codebooks:
            out["tokens"] = np.clip(
                rng.integers(0, cfg.vocab_size, (batch, cfg.num_codebooks, s),
                             dtype=np.int32), 0, cfg.vocab_size - 1)
        if cfg.vision_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
        return out

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def next_batch(self, shard_index: int = 0, num_shards: int = 1) -> dict:
        """One step's shard: batch rows [shard·b/ns, (shard+1)·b/ns)."""
        if self.cfg.global_batch % num_shards:
            raise ValueError(f"global batch {self.cfg.global_batch} does not split into "
                             f"{num_shards} shards")
        local = self.cfg.global_batch // num_shards
        full = self._batch_at(self.step, self.cfg.global_batch, seq_plus_one=True)
        out = {}
        for k, v in full.items():
            sl = v[shard_index * local:(shard_index + 1) * local]
            if k == "tokens":
                out["tokens"] = self._tensor(sl[..., :-1])
                out["labels"] = self._tensor(sl[..., 1:])
            else:
                out[k] = self._tensor(sl)
        self.step += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
