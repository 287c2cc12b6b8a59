"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch code model.  [arXiv:2405.04324]
Plain (non-gated) 4x MLP; MQA single kv head.  Pure full attention ->
long_500k skipped.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
        vocab_size=49152,
        gated_mlp=False, act="gelu",
        notes="llama-arch, code, MQA",
    ),
    reduced=ArchConfig(
        name="granite-34b", family="dense",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=1, d_ff=256,
        vocab_size=256, gated_mlp=False, act="gelu",
    ),
)
