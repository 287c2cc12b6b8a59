"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191]
Backbone only: the vision frontend is a stub — the caller provides
precomputed patch embeddings prepended to the token stream, with 3-D
(t, h, w) M-RoPE position ids supplied as inputs.  Full attention -> no
long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
        vocab_size=152064, qkv_bias=True,
        mrope=True, mrope_sections=(16, 24, 24),
        notes="M-RoPE, dynamic resolution (frontend stubbed)",
    ),
    reduced=ArchConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, qkv_bias=True,
        mrope=True, mrope_sections=(2, 3, 3),
    ),
)
