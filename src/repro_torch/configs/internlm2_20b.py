"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544; GQA. [arXiv:2403.17297; hf]

Llama-style trunk: RMSNorm, SwiGLU, RoPE theta 1e6, untied embeddings.
The largest dense arch in the pool — the ZeRO-1 + TP + SP sharding case.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    source="[arXiv:2403.17297; hf]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    layer_pattern=("attn",),
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="internlm2-20b-smoke", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=192, vocab_size=512,
    dtype="float32", param_dtype="float32",
)
