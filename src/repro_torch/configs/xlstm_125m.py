"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304; sLSTM + mLSTM
blocks. [arXiv:2405.04517; unverified]

xLSTM[1:1] layout: alternating mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory with memory mixing, sequential scan) blocks.
Blocks are self-contained (d_ff = 0): mLSTM wraps its cell in a 2x
up/down projection with SiLU output gating; sLSTM is followed by its
internal gated 4/3-factor FFN. O(1) decode state -> long_500k eligible.
"""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="[arXiv:2405.04517; unverified]",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "slstm"),
    conv_width=4,
    norm="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="xlstm-125m-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, vocab_size=512, dtype="float32",
    param_dtype="float32",
)
