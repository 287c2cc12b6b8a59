"""seamless-m4t-medium [audio]: 12L d_model=1024 16H d_ff=4096 vocab=256206
— encoder-decoder, multimodal.  [arXiv:2308.11596]
Backbone only: the speech frontend is a stub — the caller provides
precomputed frame embeddings (B, S_enc, d_model).  12 encoder + 12 decoder
layers; full attention -> no long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, encoder_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab_size=256206,
        norm="layernorm", gated_mlp=False, act="relu",
        notes="enc-dec, audio frontend stubbed",
    ),
    reduced=ArchConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=2, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, norm="layernorm", gated_mlp=False, act="relu",
    ),
)
