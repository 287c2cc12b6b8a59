"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local(4096 SWA)+global alternating attention, attn softcap 50, final logit
softcap 30, head_dim 256, GeGLU, sandwich norms.  [arXiv:2408.00118]
Alternating local/global -> local layers bound their KV at 4k; long_500k
decode runs with full-length KV only on the global layers (seq-sharded).

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
        vocab_size=256000, head_dim=256,
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=4096, local_global=True,
        gated_mlp=True, act="gelu", sandwich_norm=True,
        tie_embeddings=True, embed_scale=True,
        subquadratic=True, block_pattern=2,
        notes="local+global alternating, logit softcap",
    ),
    reduced=ArchConfig(
        name="gemma2-2b", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16,
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=32, local_global=True,
        gated_mlp=True, act="gelu", sandwich_norm=True,
        tie_embeddings=True, subquadratic=True, block_pattern=2,
    ),
)
