"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE. [arXiv:2402.19173; hf]

StarCoder2 specifics: LayerNorm (not RMSNorm), plain (non-gated) GELU MLP
with 4x expansion, RoPE theta ~1e6, tied embeddings.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    source="[arXiv:2402.19173; hf]",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    layer_pattern=("attn",),
    rope_theta=1_000_000.0,
    mlp="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="starcoder2-3b-smoke", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
    dtype="float32", param_dtype="float32",
)
