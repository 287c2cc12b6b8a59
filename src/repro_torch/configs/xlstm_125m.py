"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks.  [arXiv:2405.04517; unverified]  One sLSTM block per 4 layers
(7:1-style mix scaled to 12L); mLSTM uses matrix memory via chunkwise
linear attention.  SSM family -> runs long_500k.

A value-for-value copy of the reference's config (full and reduced)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304,
        ssm_type="xlstm", slstm_every=4, ssm_expand=2,
        subquadratic=True, block_pattern=4,
        notes="sLSTM + mLSTM blocks",
    ),
    reduced=ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=256,
        ssm_type="xlstm", slstm_every=4, ssm_expand=2,
        subquadratic=True, block_pattern=4,
    ),
)
