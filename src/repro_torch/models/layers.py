"""Shared LM layers: RoPE / M-RoPE, RMSNorm / LayerNorm, GQA attention
(train/prefill/decode), gated or plain MLP — the port of the reference's
`models/layers.py`.

Prefill (and train) attention runs through `kernels.flash_attention.ops`
and each decode step's attention through `kernels.flash_decode.ops`, where
the reference's model code calls the plain `attention_ref` and the masked
`_decode_attention`; both compute the same function (ROADMAP Queue
B.5-B.6).  Parameters are nested dicts of tensors with the reference's keys.

The `shard` argument threads the reference's logical-axis sharding
constraints (`distributed/sharding.py`) through the layers; under a
sharding config the attention kernels run on each rank's local shards
(`sharding.local_call`): batch over the data axes, heads over "model"
when both head counts divide it, whole sequences.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, d: int, device=None, dtype=torch.float32):
    if cfg.norm == "layernorm":
        return nn.layernorm_init(d, device, dtype)
    return nn.rmsnorm_init(d, device, dtype)


def norm_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return nn.layernorm(p, x)
    return nn.rmsnorm(p, x)


def act_fn(name: str):
    """The reference's activations; jax.nn.gelu is the tanh form."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections=None) -> torch.Tensor:
    """positions (B, S) or (B, S, 3) -> angles (B, S, head_dim//2).

    The inverse frequencies are theta ** -(arange(half) / half * 2), as in
    the reference.  M-RoPE (qwen2-vl): with (B, S, 3) positions the
    spectrum is cut into `mrope_sections`, each driven by one of the
    (t, h, w) ids.  (B, S) positions take plain RoPE whatever the config,
    as in the reference.
    """
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half * 2.0 + 0.0
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), expo)
    if positions.dim() == 2:
        return positions[..., None].to(torch.float32) * inv_freq
    if mrope_sections is None or sum(mrope_sections) != half:
        raise ValueError(f"(B, S, 3) positions need mrope_sections summing "
                         f"to head_dim // 2 = {half}, got {mrope_sections}")
    parts, start = [], 0
    for axis, sec in enumerate(mrope_sections):
        p = positions[..., axis].to(torch.float32)
        parts.append(p[..., None] * inv_freq[start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """x (B, S, H, head_dim); split-halves rotation in float32, cast back.
    positions (B, S), or (B, S, 3) with `mrope_sections`."""
    half = x.shape[-1] // 2
    ang = _rope_angles(SH.full(positions), x.shape[-1], theta,
                       mrope_sections)
    cos = SH.like(torch.cos(ang)[:, :, None, :], x)
    sin = SH.like(torch.sin(ang)[:, :, None, :], x)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, Hkv, head_dim)
    v: torch.Tensor


def attention_init(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32):
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": nn.dense_init(gen, d, h * hd, cfg.qkv_bias, dtype),
        "wk": nn.dense_init(gen, d, hkv * hd, cfg.qkv_bias, dtype),
        "wv": nn.dense_init(gen, d, hkv * hd, cfg.qkv_bias, dtype),
        "wo": nn.dense_init(gen, h * hd, d, False, dtype),
    }


def _decode_attention(q, cache: KVCache, valid, softcap, scale):
    """q (B, 1, H, hd) against a cache with an explicit (B, S) validity
    mask: the plain masked path of the reference."""
    b, _, h, hd = q.shape
    hkv = cache.k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd).to(torch.float32) * scale
    k = cache.k.to(torch.float32)                      # (B, S, Hkv, hd)
    v = cache.v.to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(b, 1, h * hd).to(q.dtype)


def attention_apply(p, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, layer_window: Optional[int],
                    mode: str, cache: Optional[KVCache] = None,
                    cache_pos=None, shard=SH.identity_shard):
    """x (B, S, D).  mode: train | prefill | decode.

    decode: S == 1, cache_pos (B,) current position; the new K/V are
    written into `cache` in place (slot `min(cache_pos, S - 1)`, or
    `cache_pos % S` in a ring buffer), and the cache is returned.
    Returns (out, new_cache_or_None).
    """
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)

    q = split_heads(nn.dense(p["wq"], x), h)
    k = split_heads(nn.dense(p["wk"], x), hkv)
    v = split_heads(nn.dense(p["wv"], x), hkv)
    mrope = cfg.mrope_sections if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, mrope)
    k = apply_rope(k, positions, cfg.rope_theta, mrope)
    q = shard(q, ("batch", "seq", "heads", "head_dim"))
    k = shard(k, ("batch", "seq", "kv_heads", "head_dim"))

    new_cache = None
    if mode == "decode":
        assert s == 1 and cache is not None
        out = _decode(cfg, q, k, v, cache, cache_pos, layer_window, scale,
                      shard.sc)
        new_cache = cache
    else:
        if mode == "prefill":
            new_cache = KVCache(k, v)
        def attend(q, k, v):
            out = fa_ops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=layer_window, softcap=cfg.attn_softcap,
                scale=scale)
            return out.transpose(1, 2)
        out = local_attention(attend, q, k, v, shard).reshape(b, s, h * hd)

    return shard(nn.dense(p["wo"], out), ("batch", "seq", "d_model")), \
        new_cache


def split_heads(t, n: int):
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor whose last dim is split
    into a number of shards that does not divide n is gathered along it
    first (its shards would cut heads)."""
    b, s, w = t.shape
    return SH.unshard_dim(t, 2, n).reshape(b, s, n, w // n)


def local_attention(fn, q, k, v, shard):
    """fn(q, k, v) over (B, S, H, hd) tensors; under a sharding config on
    each rank's local shards (`kernel_spec`)."""
    sc = shard.sc
    if sc is None:
        return fn(q, k, v)
    spec = kernel_spec(sc, q.shape[0], q.shape[2], k.shape[2])
    return SH.local_call(fn, (q, k, v), (spec,) * 3, spec, sc.mesh)


def kernel_spec(sc, b: int, h: int, hkv: int):
    """The spec of q (B, S, H, hd) and k / v (B, S, Hkv, hd) for an
    attention kernel on local shards: batch over the data axes when it
    divides, heads over "model" when both head counts divide it (so each
    rank's query heads use its own KV heads), sequences whole."""
    data = sc.data_spec if SH.divides(b, sc.n_data) else None
    heads = "model" if SH.divides(h, sc.n_model) and \
        SH.divides(hkv, sc.n_model) else None
    return (data, None, heads, None)


def _decode(cfg: ArchConfig, q, k, v, cache: KVCache, cache_pos,
            layer_window, scale, sc):
    """One decode step's attention: the new K/V are written into `cache`
    in place (slot `min(cache_pos, S - 1)`, or `cache_pos % S` in a ring
    buffer; on a cache placed by `state_specs` into each rank's local
    shard, `sharding.write_rows`), then attention reads the cache.  Under
    `sc` it runs on local shards with whole sequences (a cache whose
    sequence is sharded is gathered for the read)."""
    b, _, h, hd = q.shape
    s_cache = cache.k.shape[1]
    ring = layer_window is not None and s_cache <= layer_window
    # SWA layers keep a ring buffer of exactly `window` slots; rope is
    # applied at absolute positions before caching.  Past the end of a
    # plain cache the write lands in its last slot: the reference's
    # dynamic_update_slice clamps it there
    slot = (cache_pos % s_cache if ring
            else cache_pos.clamp(0, s_cache - 1))
    SH.write_rows(cache.k, slot, SH.full(k)[:, 0].to(cache.k.dtype))
    SH.write_rows(cache.v, slot, SH.full(v)[:, 0].to(cache.v.dtype))

    if layer_window is not None and not ring:
        # a windowed cache longer than its window: the valid slots are no
        # prefix, so no `lengths` describes them.  The reference takes its
        # masked path here, on every device (it has no kernel for decode
        # attention), and so does the port
        kpos = torch.arange(s_cache, device=cache_pos.device)[None, :]
        valid = (kpos <= cache_pos[:, None]) \
            & (kpos > cache_pos[:, None] - layer_window)

        def attend(q, ck, cv, valid):
            return _decode_attention(q, KVCache(ck, cv), valid,
                                     cfg.attn_softcap, scale)
        args = (q, cache.k, cache.v, valid)
    else:
        # full attention, or a ring buffer: the first min(pos + 1, S)
        # slots are valid
        lengths = torch.clamp(cache_pos + 1, max=s_cache).to(torch.int32)

        def attend(q, ck, cv, lengths):
            out = fd_ops.flash_decode(q[:, 0], ck, cv, lengths,
                                      softcap=cfg.attn_softcap, scale=scale)
            return out.reshape(q.shape[0], 1, -1)
        args = (q, cache.k, cache.v, lengths)
    if sc is None:
        return attend(*args)
    spec = kernel_spec(sc, b, h, k.shape[2])
    row_spec = spec[:1] + (None,) * (args[3].dim() - 1)
    return SH.local_call(attend, args, (spec, spec, spec, row_spec),
                         (spec[0], None, spec[2]), sc.mesh)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, dtype=torch.float32):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": nn.dense_init(gen, d, f, False, dtype),
         "wo": nn.dense_init(gen, f, d, False, dtype)}
    if cfg.gated_mlp:
        p["wg"] = nn.dense_init(gen, d, f, False, dtype)
    return p


def mlp_apply(p, cfg: ArchConfig, x: torch.Tensor,
              shard=SH.identity_shard) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = nn.dense(p["wi"], x)
    if "wg" in p:
        h = act(nn.dense(p["wg"], x)) * h
    else:
        h = act(h)
    h = shard(h, ("batch", "seq", "d_ff"))
    return shard(nn.dense(p["wo"], h), ("batch", "seq", "d_model"))
