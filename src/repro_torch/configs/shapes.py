"""Assigned input shapes (per-arch shape set for the LM pool).

A copy of the reference package's ``configs/shapes.py`` (the port imports
nothing of it). ``train_*`` traces the train step; ``prefill_*`` the
prefill step; ``decode_*`` / ``long_*`` the decode step (one new token
with a KV cache of seq_len). ``long_500k`` is sub-quadratic-only
(cfg.sub_quadratic).
"""

from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES", "get_shape", "cells_for"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> Shape:
    return SHAPES[name]


def cells_for(cfg) -> list[str]:
    """Runnable shape names for an arch (long_500k only if sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
