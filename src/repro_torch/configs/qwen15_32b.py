"""qwen1.5-32b [dense]: 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5]  Full attention -> no
long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
        vocab_size=152064, qkv_bias=True,
        notes="QKV bias",
    ),
    reduced=ArchConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
        vocab_size=256, qkv_bias=True,
    ),
)
