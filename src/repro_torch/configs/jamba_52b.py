"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every
other layer.  [arXiv:2403.19887]
Scan body = 8 layers (7 mamba + 1 attn; MoE on odd sub-layers).
Hybrid -> runs long_500k (only 4 attention layers hold KV).

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=65536,
        n_experts=16, topk=2, moe_every=2,
        attn_every=8, ssm_type="mamba", d_state=16, d_conv=4, ssm_expand=2,
        subquadratic=True, block_pattern=8,
        notes="Mamba+attn 1:7 interleave, MoE 16e top-2",
    ),
    reduced=ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256,
        n_experts=4, topk=2, moe_every=2,
        attn_every=8, ssm_type="mamba", d_state=8, d_conv=4, ssm_expand=2,
        subquadratic=True, block_pattern=8,
    ),
)
