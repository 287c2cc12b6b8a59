"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 8e
top-2, vocab=32000, sliding-window attention.  [arXiv:2401.04088]
SWA bounds the KV cache -> runs long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=32000,
        n_experts=8, topk=2, sliding_window=4096,
        subquadratic=True,
        notes="8 experts top-2, SWA",
    ),
    reduced=ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, n_experts=4, topk=2, sliding_window=32,
        subquadratic=True,
    ),
)
