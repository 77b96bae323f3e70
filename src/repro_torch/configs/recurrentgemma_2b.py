"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, temporal pattern (R, R, A).
[arXiv:2402.19427; hf]

Griffin recipe: blocks of two RG-LRU recurrent mixers followed by one
local (window 2048) MQA attention layer; GeGLU MLPs; Gemma-style
sqrt(d_model) embedding scaling; tied embeddings. 26 = (R,R,A)×8 + (R,R).
Sub-quadratic: O(1) recurrent state + bounded local window -> long_500k.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="[arXiv:2402.19427; hf]",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rnn_width=2560,
    conv_width=4,
    mlp="geglu",
    norm="rmsnorm",
    emb_scale=2560.0 ** 0.5,
    query_scale=256.0 ** -0.5,
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="recurrentgemma-2b-smoke", num_layers=5, d_model=64,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    rnn_width=64, local_window=16, emb_scale=8.0, query_scale=16.0 ** -0.5,
    dtype="float32", param_dtype="float32",
)
