"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (MHA kv=16) d_ff=1024/expert
vocab=50304; 64 experts top-8. [arXiv:2409.02060; hf]

OLMoE specifics: every MLP is an MoE (64 experts, top-8, gates softmax-
then-topk renormalised), QK-norm, SwiGLU experts, untied embeddings.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="[arXiv:2409.02060; hf]",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    layer_pattern=("attn",),
    qk_norm=True,
    mlp="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    moe_experts=64,
    moe_top_k=8,
    moe_capacity_factor=1.25,
    tie_embeddings=False,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="olmoe-1b-7b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=64, vocab_size=512, moe_experts=8,
    moe_top_k=2, dtype="float32", param_dtype="float32",
)
