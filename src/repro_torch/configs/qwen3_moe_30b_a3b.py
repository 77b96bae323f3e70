"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936; 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Qwen3-MoE specifics: every MLP is an MoE (128 experts, top-8, renormalised
gates, no shared expert), QK-norm, head_dim 128, RoPE theta 1e6, untied
embeddings. ~30B total / ~3B active parameters.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    layer_pattern=("attn",),
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp="swiglu",
    norm="rmsnorm",
    moe_experts=128,
    moe_top_k=8,
    moe_capacity_factor=1.25,
    tie_embeddings=False,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="qwen3-moe-30b-a3b-smoke", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512,
    moe_experts=8, moe_top_k=2, dtype="float32", param_dtype="float32",
)
