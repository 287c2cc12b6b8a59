"""ArchConfig dataclass + registry: a copy of the reference's
`configs/base.py` over all of its configs."""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

_REGISTRY: dict = {}

_ARCH_MODULES = [
    "gemma2_2b", "granite_34b", "qwen15_4b", "qwen15_32b", "jamba_52b",
    "xlstm_125m", "seamless_m4t_medium", "granite_moe_1b", "mixtral_8x7b",
    "qwen2_vl_72b", "minkunet", "mini_minkunet",
]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|hybrid|ssm|audio|vlm|pointcloud
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: Optional[int] = None  # defaults to d_model // n_heads

    # attention details
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None      # gemma2
    final_softcap: Optional[float] = None     # gemma2
    sliding_window: Optional[int] = None      # SWA width
    local_global: bool = False                # gemma2 alternating pattern
    rope_theta: float = 10000.0
    mrope: bool = False                       # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # MLP
    gated_mlp: bool = True                    # SwiGLU vs plain
    act: str = "silu"

    # MoE
    n_experts: int = 0
    topk: int = 0
    moe_every: int = 1          # a MoE FFN every k-th layer (jamba: 2)

    # hybrid / ssm
    attn_every: int = 0         # jamba: 1 attention layer per this many
    ssm_type: Optional[str] = None            # "mamba" | "xlstm"
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0        # xlstm: sLSTM block frequency

    # encoder-decoder (audio)
    encoder_layers: int = 0

    norm: str = "rmsnorm"                      # rmsnorm | layernorm
    sandwich_norm: bool = False                # gemma2 post-norms
    tie_embeddings: bool = False
    embed_scale: bool = False                  # gemma2 sqrt(d) embed scaling

    # shape policy / structure
    subquadratic: bool = False                 # runs long_500k
    block_pattern: int = 1                     # layers per scan body
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // \
            max(1, self.n_heads)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def register(cfg: ArchConfig, reduced: "ArchConfig" = None):
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def _load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get(name: str, reduced: bool = False) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg, red = _REGISTRY[name]
    return red if reduced else cfg


def list_archs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)
