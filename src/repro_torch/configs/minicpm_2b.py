"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753; Llama-like arch trained with the WSD schedule.
[arXiv:2404.06395; hf]

MiniCPM specifics: embedding scale 12, depth-scaled residuals
(scale_depth 1.4 / sqrt(L)), logits scaled by dim_model_base/d_model =
256/2304, tied embeddings. The WSD (warmup-stable-decay) schedule is the
training-side counterpart — see the reference package's optim.optimizer.wsd_schedule.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="[arXiv:2404.06395; hf]",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    layer_pattern=("attn",),
    mlp="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    emb_scale=12.0,
    residual_scale=1.4 / 40.0 ** 0.5,
    logit_scale=256.0 / 2304.0,
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="minicpm-2b-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, emb_scale=12.0,
    residual_scale=1.4 / 3.0 ** 0.5, logit_scale=0.5, dtype="float32",
    param_dtype="float32",
)
