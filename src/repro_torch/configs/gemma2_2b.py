"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]

Gemma-2 specifics: alternating sliding-window (4096) and global layers,
attention logit softcap 50, final logit softcap 30, pre+post block norms,
GeGLU, head_dim 256 with query scale 256^-1/2, sqrt(d) embedding scale,
tied embeddings.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="[arXiv:2408.00118; hf]",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local", "attn"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    mlp="geglu",
    norm="rmsnorm",
    emb_scale=2304.0 ** 0.5,
    query_scale=256.0 ** -0.5,
    tie_embeddings=True,
    sub_quadratic=False,   # global layers are full attention
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="gemma2-2b-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, local_window=16,
    emb_scale=8.0, query_scale=16.0 ** -0.5, dtype="float32",
    param_dtype="float32",
)
