"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
MoE 32e top-8, vocab=49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
Highest routing irregularity in the pool (top-8 of 32) — flagship target
for the PointAcc sorted dispatch.  Full attention -> no long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab_size=49155,
        n_experts=32, topk=8,
        notes="32 experts top-8",
    ),
    reduced=ArchConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab_size=256, n_experts=8, topk=4,
    ),
)
