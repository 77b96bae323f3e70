"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision frontend is a STUB per assignment: input_specs provides precomputed
patch embeddings (B, 1600, 1280) fed through a linear projector into the
gated cross-attention layers (8 cross layers interleaved with the 32
self-attention layers of the Llama-3.1-8B text trunk -> 40 total).
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=("attn", "attn", "attn", "attn", "cross"),
    rope_theta=500000.0,
    mlp="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    vision_tokens=1600,
    vision_dim=1280,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="llama-3.2-vision-11b-smoke", num_layers=5, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    vision_tokens=8, vision_dim=32, dtype="float32", param_dtype="float32",
)
