"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Audio frontend is a STUB per assignment: the model consumes 4 parallel
EnCodec codebook token streams (B, 4, S); codebook embeddings are summed
(MusicGen's delay-pattern sum) and each codebook has its own LM head.
LayerNorm + plain-GELU MLP + sinusoidal positions per the paper.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="[arXiv:2306.05284; hf]",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=("attn",),
    pos_embedding="sinusoidal",
    mlp="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    num_codebooks=4,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="musicgen-medium-smoke", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
    num_codebooks=2, dtype="float32", param_dtype="float32",
)
