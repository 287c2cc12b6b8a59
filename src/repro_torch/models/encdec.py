"""Encoder-decoder backbone of seamless-m4t-medium — the port of the
reference's `models/encdec.py`.

Only the transformer backbone is modelled: the speech frontend is a stub,
and the caller supplies precomputed frame embeddings (B, S_enc, d_model) to
the encoder.  The encoder is a bidirectional stack with RoPE on
`enc_positions`; the decoder is a causal stack with cross-attention onto
the encoder's output.  Decode caches each layer's self-attention K/V and
the cross-attention K/V, computed once at prefill and only read after.

Layer leaves stay stacked on a leading layer axis (`enc_layers.*`,
`dec_layers.*`), so the parameter keys and shapes are the reference's one
to one.  The encoder's attention and the cross-attention run the plain
`attention_ref`, as the reference's do; the decoder's self-attention goes
through `layers.attention_apply`, so on the card a prefill launches
flash_attention and a decode step flash_decode.  The frame embeddings are
cast to the weights' dtype (the reference's abstract inputs give them in
the compute dtype).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import identity_shard
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as L
from repro_torch.models.lm import _index, _stack, param_tree, stack_drawn
from repro_torch.models.params import ParamTree, tree_map


class CrossCache(NamedTuple):
    k: torch.Tensor   # (B, S_enc, H, hd): static after prefill
    v: torch.Tensor


class DecLayerState(NamedTuple):
    self_kv: L.KVCache
    cross: CrossCache


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------

def cross_attention_init(gen: torch.Generator, cfg: ArchConfig,
                         dtype=torch.float32):
    d, h = cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": nn.dense_init(gen, d, h * hd, cfg.qkv_bias, dtype),
        "wk": nn.dense_init(gen, d, h * hd, cfg.qkv_bias, dtype),
        "wv": nn.dense_init(gen, d, h * hd, cfg.qkv_bias, dtype),
        "wo": nn.dense_init(gen, h * hd, d, False, dtype),
    }


def cross_kv(p, cfg: ArchConfig, enc_out: torch.Tensor) -> CrossCache:
    b, se, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    k = L.split_heads(nn.dense(p["wk"], enc_out), h)
    v = L.split_heads(nn.dense(p["wv"], enc_out), h)
    return CrossCache(k, v)


def cross_attention_apply(p, cfg: ArchConfig, x: torch.Tensor,
                          cache: CrossCache,
                          shard=identity_shard) -> torch.Tensor:
    """x (B, S_dec, D) attends to all S_enc rows of `cache`: no mask, no
    RoPE."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = L.split_heads(nn.dense(p["wq"], x), h)
    out = L.local_attention(
        lambda q, k, v: attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      causal=False).transpose(1, 2),
        q, cache.k, cache.v, shard)
    out = out.reshape(b, s, h * hd)
    return shard(nn.dense(p["wo"], out), ("batch", "seq", "d_model"))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def enc_layer_init(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32):
    return {
        "norm_attn": L.norm_init(cfg, cfg.d_model, gen.device, dtype),
        "attn": L.attention_init(gen, cfg, dtype),
        "norm_ffn": L.norm_init(cfg, cfg.d_model, gen.device, dtype),
        "ffn": L.mlp_init(gen, cfg, dtype=dtype),
    }


def enc_layer_apply(p, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor,
                    shard=identity_shard) -> torch.Tensor:
    h = L.norm_apply(cfg, p["norm_attn"], x)
    b, s, _ = h.shape
    hh, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = L.split_heads(nn.dense(p["attn"]["wq"], h), hh)
    k = L.split_heads(nn.dense(p["attn"]["wk"], h), hkv)
    v = L.split_heads(nn.dense(p["attn"]["wv"], h), hkv)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.local_attention(                               # bidirectional
        lambda q, k, v: attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      causal=False).transpose(1, 2),
        q, k, v, shard)
    o = o.reshape(b, s, hh * hd)
    x = x + nn.dense(p["attn"]["wo"], o)
    x = x + L.mlp_apply(p["ffn"], cfg, L.norm_apply(cfg, p["norm_ffn"], x),
                        shard=shard)
    return shard(x, ("batch", "seq", "d_model"))


# ---------------------------------------------------------------------------
# decoder layer
# ---------------------------------------------------------------------------

def dec_layer_init(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32):
    def norm():
        return L.norm_init(cfg, cfg.d_model, gen.device, dtype)
    return {
        "norm_self": norm(),
        "self": L.attention_init(gen, cfg, dtype),
        "norm_cross": norm(),
        "cross": cross_attention_init(gen, cfg, dtype),
        "norm_ffn": norm(),
        "ffn": L.mlp_init(gen, cfg, dtype=dtype),
    }


def dec_layer_apply(p, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, mode: str, enc_out=None,
                    state: Optional[DecLayerState] = None, cache_pos=None,
                    shard=identity_shard):
    """Returns (x, new_state): None in train mode; in decode mode the
    state's self-attention cache is written in place and its cross cache
    read as it is."""
    h = L.norm_apply(cfg, p["norm_self"], x)
    h, self_kv = L.attention_apply(
        p["self"], cfg, h, positions, layer_window=None, mode=mode,
        cache=state.self_kv if state is not None else None,
        cache_pos=cache_pos, shard=shard)
    x = x + h

    h = L.norm_apply(cfg, p["norm_cross"], x)
    cc = state.cross if mode == "decode" else cross_kv(p["cross"], cfg,
                                                       enc_out)
    x = x + cross_attention_apply(p["cross"], cfg, h, cc, shard=shard)

    h = L.norm_apply(cfg, p["norm_ffn"], x)
    x = x + L.mlp_apply(p["ffn"], cfg, h, shard=shard)
    return shard(x, ("batch", "seq", "d_model")), \
        (DecLayerState(self_kv, cc) if mode != "train" else None)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def encdec_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> ParamTree:
    """The reference's parameter tree (encoder and decoder layers stacked on
    a leading axis, an untied `lm_head`) as a `ParamTree` in `dtype` on
    `resolve_device(device)`; each leaf is drawn in float32 on the
    generator's device and cast to `dtype` as it is drawn."""
    dev = resolve_device(device)
    params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "enc_layers": stack_drawn(lambda: enc_layer_init(gen, cfg, dtype),
                                  cfg.encoder_layers),
        "enc_norm": L.norm_init(cfg, cfg.d_model, gen.device, dtype),
        "dec_layers": stack_drawn(lambda: dec_layer_init(gen, cfg, dtype),
                                  cfg.n_layers),
        "final_norm": L.norm_init(cfg, cfg.d_model, gen.device, dtype),
        "lm_head": nn.dense_init(gen, cfg.d_model, cfg.vocab_size, False,
                                 dtype),
    }
    return ParamTree(tree_map(lambda x: x.to(dev), params))


def init_encdec_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None,
                      enc_len: Optional[int] = None) -> DecLayerState:
    """Zeroed decode state on `resolve_device(device)`, stacked over the
    decoder layers: a `max_len` self-attention cache and an `enc_len` (or
    `max_len`) cross cache a layer."""
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    n = cfg.n_layers

    def zeros(s, heads):
        return torch.zeros((n, batch, s, heads, hd), dtype=dtype, device=dev)
    enc_len = enc_len or max_len
    return DecLayerState(
        self_kv=L.KVCache(zeros(max_len, cfg.n_kv_heads),
                          zeros(max_len, cfg.n_kv_heads)),
        cross=CrossCache(zeros(enc_len, cfg.n_heads),
                         zeros(enc_len, cfg.n_heads)))


def encode(params, cfg: ArchConfig, frame_embeds: torch.Tensor,
           enc_positions: torch.Tensor,
           shard=identity_shard) -> torch.Tensor:
    """frame_embeds (B, S_enc, D): the stubbed audio frontend's output."""
    params = param_tree(params)
    x = shard(frame_embeds.to(params["embed"]["emb"].dtype),
              ("batch", "seq", "d_model"))
    for i in range(cfg.encoder_layers):
        x = enc_layer_apply(_index(params["enc_layers"], i), cfg, x,
                            enc_positions, shard)
    return L.norm_apply(cfg, params["enc_norm"], x)


def encdec_apply(params, cfg: ArchConfig, frame_embeds, enc_positions,
                 tokens, dec_positions, *, mode: str = "train", states=None,
                 cache_pos=None, remat: bool = False,
                 return_hidden: bool = False, shard=identity_shard):
    """Returns (logits, new_states, aux = 0).  train: no state, `remat`
    recomputes each decoder layer in the backward pass; prefill: the
    decoder's states stacked over its layers (self K/V of S_dec rows, cross
    K/V of S_enc rows); decode: `states` updated in place (the frames are
    not read).  `return_hidden` gives the final-normed hidden states in
    place of the logits."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    params = param_tree(params)
    x = shard(nn.embed(params["embed"], tokens), ("batch", "seq", "d_model"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "decode":
        for i in range(cfg.n_layers):
            x, _ = dec_layer_apply(
                _index(params["dec_layers"], i), cfg, x, dec_positions,
                mode="decode", state=_index(states, i), cache_pos=cache_pos,
                shard=shard)
        new_states = states
    else:
        enc_out = encode(params, cfg, frame_embeds, enc_positions, shard)

        def body(x, p_layer):
            return dec_layer_apply(p_layer, cfg, x, dec_positions, mode=mode,
                                   enc_out=enc_out, shard=shard)[0]
        per_layer = []
        for i in range(cfg.n_layers):
            p_layer = _index(params["dec_layers"], i)
            if mode == "train":
                x = checkpoint(body, x, p_layer, use_reentrant=False) \
                    if remat else body(x, p_layer)
                continue
            x, st = dec_layer_apply(p_layer, cfg, x, dec_positions,
                                    mode=mode, enc_out=enc_out, shard=shard)
            per_layer.append(st)
        new_states = _stack(per_layer) if mode == "prefill" else None

    x = L.norm_apply(cfg, params["final_norm"], x)
    if return_hidden:
        return x, new_states, aux
    return shard(nn.dense(params["lm_head"], x), ("batch", "seq", "vocab")), \
        new_states, aux
