"""qwen1.5-4b [dense]: 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5]  Full attention -> no
long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
        vocab_size=151936, qkv_bias=True,
        notes="QKV bias",
    ),
    reduced=ArchConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, qkv_bias=True,
    ),
)
