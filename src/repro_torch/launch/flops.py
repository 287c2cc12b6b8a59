"""Analytic FLOP model per architecture x shape — a copy of the
reference's `launch/flops.py` over the port's `body_layout`.

Counted from the shapes alone, so the same numbers hold on any device;
`body_layout` raises for a config the port cannot run.  The trainer's
share of the card is `cell_flops(...)["total"]` over the step time and
the card's dense bf16 peak (chip_smoke.py phase 13).

Conventions: multiply-accumulate = 2 FLOPs; training = 3x forward
(fwd + 2x bwd); `remat` adds one extra forward (+1x).  Attention score
FLOPs use the average attended length under causal masking.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import body_layout


def _attn_len(seq_q: int, kv_len: int, window, causal=True) -> float:
    """Average attended kv length per query."""
    if window is not None:
        kv_len = min(kv_len, window)
        # causal + window: ramps up to w then flat
        if causal and seq_q > 1:
            w = kv_len
            ramp = min(seq_q, w)
            avg = (ramp * (ramp + 1) / 2 + max(0, seq_q - w) * w) / seq_q
            return avg
        return kv_len
    if causal and seq_q > 1:
        return (kv_len + 1) / 2
    return kv_len


def attn_flops(cfg: ArchConfig, seq_q: int, kv_len: int, window) -> float:
    """Per-sequence forward FLOPs of one attention layer."""
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    proj = 2 * seq_q * d * (h + 2 * hkv) * hd + 2 * seq_q * h * hd * d
    L = _attn_len(seq_q, kv_len, window)
    scores = 2 * seq_q * L * h * hd * 2        # qk^T and pv
    return proj + scores


def mlp_flops(cfg: ArchConfig, seq: int, d_ff=None) -> float:
    f = d_ff or cfg.d_ff
    n_mats = 3 if cfg.gated_mlp else 2
    return 2 * seq * cfg.d_model * f * n_mats


def moe_flops(cfg: ArchConfig, seq: int) -> float:
    router = 2 * seq * cfg.d_model * cfg.n_experts
    return router + cfg.topk * mlp_flops(cfg, seq)


def mamba_flops(cfg: ArchConfig, seq: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.d_state
    dtr = max(1, -(-d // 16))
    proj = 2 * seq * d * 2 * di + 2 * seq * di * (dtr + 2 * n) \
        + 2 * seq * dtr * di + 2 * seq * di * d
    conv = 2 * seq * cfg.d_conv * di
    scan = seq * di * n * 10          # da/u build + assoc-scan + readout
    return proj + conv + scan


def mlstm_flops(cfg: ArchConfig, seq: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    hh = cfg.n_heads
    dk = di // hh
    proj = 2 * seq * d * 2 * di + 3 * 2 * seq * di * di \
        + 2 * seq * di * 2 * hh + 2 * seq * di * d
    cell = seq * hh * dk * dk * 6     # kv outer + C update + readout
    return proj + cell


def slstm_flops(cfg: ArchConfig, seq: int) -> float:
    d = cfg.d_model
    return 2 * seq * d * 4 * d * 2 + seq * d * 12


def head_flops(cfg: ArchConfig, seq: int) -> float:
    return 2 * seq * cfg.d_model * cfg.vocab_size


def forward_flops(cfg: ArchConfig, seq_q: int, kv_len: int,
                  with_head: bool = True) -> float:
    """Per-sequence forward FLOPs of the whole stack (decode: seq_q=1,
    kv_len = context length)."""
    total = 0.0
    if cfg.family == "audio":
        s_enc = kv_len            # caller passes encoder length via kv_len
        decode = seq_q == 1
        if not decode:            # decode reuses the cached encoder pass
            for _ in range(cfg.encoder_layers):
                total += attn_flops(cfg, s_enc, s_enc, None)
                total += mlp_flops(cfg, s_enc)
        s_dec = seq_q
        d, h = cfg.d_model, cfg.n_heads
        hd = cfg.resolved_head_dim
        for _ in range(cfg.n_layers):
            total += attn_flops(cfg, s_dec, s_dec if not decode else
                                kv_len, None)                   # self
            # cross attention: q/out proj + scores vs the cached enc kv;
            # the enc kv projection itself is cached at prefill
            total += 2 * s_dec * d * 2 * h * hd                 # q + out
            total += 2 * s_dec * s_enc * h * hd * 2             # scores+pv
            if not decode:
                total += 2 * s_enc * d * 2 * h * hd             # cross kv
            total += mlp_flops(cfg, s_dec)
        if with_head:
            total += head_flops(cfg, s_dec)
        return total

    specs = body_layout(cfg)
    n_bodies = cfg.n_layers // cfg.block_pattern
    body = 0.0
    for spec in specs:
        if spec.kind == "attn":
            body += attn_flops(cfg, seq_q, kv_len, spec.window)
        elif spec.kind == "mamba":
            body += mamba_flops(cfg, seq_q)
        elif spec.kind == "mlstm":
            body += mlstm_flops(cfg, seq_q)
        elif spec.kind == "slstm":
            body += slstm_flops(cfg, seq_q)
        if spec.ffn == "dense":
            body += mlp_flops(cfg, seq_q)
        elif spec.ffn == "moe":
            body += moe_flops(cfg, seq_q)
    total = body * n_bodies
    if with_head:
        total += head_flops(cfg, seq_q)
    return total


def cell_flops(cfg: ArchConfig, shape, remat: bool = True) -> dict:
    """Global FLOPs for one dry-run cell (whole step, all chips)."""
    b, s = shape.batch, shape.seq
    if cfg.family == "audio" and shape.kind != "decode":
        s_dec = max(128, s // 4)
        fwd = b * forward_flops(cfg, s_dec, s)
    elif cfg.family == "vlm" and shape.kind != "decode":
        fwd = b * forward_flops(cfg, s, s)
    elif shape.kind == "decode":
        fwd = b * forward_flops(cfg, 1, s)
    else:
        fwd = b * forward_flops(cfg, s, s)

    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat else 0.0)
        total = fwd * mult
    else:
        total = fwd
    return {"forward": fwd, "total": total}
