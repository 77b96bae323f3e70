"""Architecture config system: dataclass, registry, CLI overrides.

A copy of the reference package's config system (the port imports nothing
of it). Every architecture is a frozen :class:`ArchConfig` in its own
module under ``repro_torch.configs``; ``get_config(name)`` returns the
exact configuration, ``get_config(name, smoke=True)`` a reduced
same-family variant for CPU tests. ``apply_overrides`` implements
``--set field=value`` launcher overrides.

The dataclass keeps every field of the reference, so later families only
add configs; the registry names only the architectures whose blocks the
port can run (attention-only dense trunks).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

__all__ = ["ArchConfig", "register", "get_config", "list_archs", "apply_overrides"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # provenance note "[arXiv:... ; tier]"

    # trunk dimensions
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: Optional[int] = None   # default: d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # block pattern: kinds repeated (truncated) to num_layers.
    # kinds: attn | local | cross | rglru | slstm | mlstm
    layer_pattern: Tuple[str, ...] = ("attn",)

    # attention details
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"      # rope | sinusoidal | none
    local_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)

    # mlp / norms
    mlp: str = "swiglu"              # swiglu | geglu | gelu (plain, non-gated)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_norms: bool = False         # gemma2-style pre+post block norms

    # embeddings / head
    emb_scale: Optional[float] = None      # e.g. sqrt(d) (gemma), 12 (minicpm)
    logit_scale: Optional[float] = None    # e.g. minicpm 256/d_model
    tie_embeddings: bool = True
    residual_scale: Optional[float] = None # minicpm scale_depth/sqrt(L)

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01

    # recurrent (RG-LRU / xLSTM)
    rnn_width: Optional[int] = None  # RG-LRU lru_width
    conv_width: int = 4              # temporal conv kernel

    # modality stubs
    vision_tokens: int = 0           # [vlm] number of precomputed patch embeds
    vision_dim: int = 0              # [vlm] patch embedding dim (pre-projector)
    num_codebooks: int = 0           # [audio] EnCodec codebooks

    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    sub_quadratic: bool = False      # eligible for long_500k
    kv_quant: bool = False           # int8 KV cache (serving memory lever)

    def __post_init__(self):
        if self.head_dim is None and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.num_layers]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim or 0
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.num_codebooks:
            total = self.num_codebooks * v * d * 2
        for kind in self.layer_kinds:
            if kind in ("attn", "local", "cross"):
                total += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                total += self.num_heads * hd * d
            if kind == "rglru":
                r = self.rnn_width or d
                total += 2 * d * r + r * d + self.conv_width * r + 3 * r
            if kind == "mlstm":
                total += 2 * d * 2 * d + 3 * (2 * d) * (2 * d) // 4 + 2 * d * d
            if kind == "slstm":
                total += 4 * d * d + 4 * d * d // 4 + int(2 * 4 / 3 * d * d)
            if kind in ("attn", "local", "cross", "rglru"):
                if self.moe_experts:
                    total += self.moe_experts * 3 * d * f + d * self.moe_experts
                elif f:
                    gated = self.mlp in ("swiglu", "geglu")
                    total += (3 if gated else 2) * d * f
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.moe_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.num_layers * self.moe_experts * 3 * d * f
        return dense + self.num_layers * self.moe_top_k * 3 * d * f


_REGISTRY: dict[str, str] = {}   # name -> module path


def register(name: str, module: str) -> None:
    _REGISTRY[name] = module


# The architectures the port runs: the dense attention trunks (``attn`` and
# ``local`` blocks), the MoE trunks (olmoe, qwen3-moe) and the RG-LRU hybrid
# (recurrentgemma). The xLSTM, vision and audio configs join when their
# modules are ported (ROADMAP A14).
for _n, _m in {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}.items():
    register(_n, _m)


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(_REGISTRY[name])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def apply_overrides(cfg: ArchConfig, overrides: list[str]) -> ArchConfig:
    """--set field=value (int/float/str/bool auto-coerced)."""
    updates = {}
    for item in overrides:
        field, _, raw = item.partition("=")
        f = {f.name: f for f in dataclasses.fields(ArchConfig)}[field]
        if raw in ("true", "True", "false", "False"):
            val = raw.lower() == "true"
        else:
            try:
                val = int(raw)
            except ValueError:
                try:
                    val = float(raw)
                except ValueError:
                    val = raw
        updates[field] = val
    return dataclasses.replace(cfg, **updates)
