"""Causal LM assembly: heterogeneous sub-layer bodies over depth — the port
of the reference's `models/lm.py`.

The reference scans (`lax.scan`) over "bodies" of `cfg.block_pattern`
sub-layers whose parameters are stacked along a leading `n_bodies` axis
(`jax.vmap` over `body_init`).  The port keeps them stacked, so parameter
keys and shapes match the reference's one to one, and runs a Python loop
over bodies in place of the scan.

Modes: "train" (no state; `remat=True` checkpoints each body with
`torch.utils.checkpoint`, as the reference `jax.checkpoint`s it, so only
the bodies' boundary activations survive the forward), "prefill" (produce
per-body states, stacked), "decode" (consume states and update them in
place: attention writes its KV slot into the stacked cache, and the
recurrent mixers' new states are copied into the stacked tree; the
counterpart of the reference's donated buffers).  Sub-layers are attention
(dense or MoE FFN, QKV bias, sliding or local/global windows, softcaps),
mamba (`models/mamba.py`, the jamba hybrid) and mLSTM / sLSTM
(`models/xlstm.py`); gemma2's sandwich norms, embedding scale, tied head
and final softcap, qwen2-vl's M-RoPE (positions (B, S, 3)) and patch
embeddings (`embeds=`, prepended to the token rows) and layernorm
(`cfg.norm`) are ported too.

`lm_init(generator, cfg, dtype, device=None)` draws the reference's shapes
and distributions from a `torch.Generator` (on the generator's device) and
returns a `ParamTree` on `resolve_device(device)`: the card unless the
caller passes `device="cpu"`.  Each leaf is drawn in float32 and cast to
`dtype` as it is drawn, into stacked leaves, so the init's peak is the
finished tree in `dtype` plus one body in `dtype` (none with one body) and
the largest leaf in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL
from repro_torch.models.params import ParamTree, tree_map


class SubLayerSpec(NamedTuple):
    kind: str               # attn | mamba | mlstm | slstm
    ffn: Optional[str]      # dense | moe | None
    window: Optional[int]   # per-layer attention window


def body_layout(cfg: ArchConfig):
    """Static description of one body (cfg.block_pattern sub-layers)."""
    subs = []
    for i in range(cfg.block_pattern):
        if cfg.ssm_type == "xlstm":
            kind = "slstm" if (cfg.slstm_every and
                               i % cfg.slstm_every == cfg.slstm_every - 1) \
                else "mlstm"
            subs.append(SubLayerSpec(kind, None, None))
            continue
        if cfg.ssm_type == "mamba":
            # jamba: one attention layer per attn_every, middle of the block
            kind = "attn" if i == cfg.attn_every // 2 else "mamba"
        else:
            kind = "attn"
        if cfg.n_experts:
            ffn = "moe" if i % cfg.moe_every == cfg.moe_every - 1 else \
                "dense"
        else:
            ffn = "dense" if cfg.d_ff else None
        window = None
        if kind == "attn" and cfg.sliding_window is not None:
            if cfg.local_global:
                window = cfg.sliding_window if i % 2 == 0 else None
            else:
                window = cfg.sliding_window
        subs.append(SubLayerSpec(kind, ffn, window))
    return subs


# ---------------------------------------------------------------------------
# stacked trees (bodies on a leading axis)
# ---------------------------------------------------------------------------

def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def param_tree(params):
    """The nested dict of a `ParamTree` (a nested dict passes through)."""
    return params.tree() if isinstance(params, ParamTree) else params


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_MIXER_INITS = {"attn": L.attention_init, "mamba": MB.mamba_init,
                "mlstm": XL.mlstm_block_init, "slstm": XL.slstm_block_init}


def _sublayer_init(gen, cfg: ArchConfig, spec: SubLayerSpec,
                   dtype=torch.float32):
    def norm():
        return L.norm_init(cfg, cfg.d_model, gen.device, dtype)
    p: dict = {"norm_mix": norm(), "mix": _MIXER_INITS[spec.kind](gen, cfg,
                                                                  dtype=dtype)}
    if cfg.sandwich_norm:
        p["norm_mix_post"] = norm()
    if spec.ffn is not None:
        p["norm_ffn"] = norm()
        if spec.ffn == "moe":
            p["ffn"] = MOE.moe_init(gen, cfg, dtype=dtype)
        else:
            p["ffn"] = L.mlp_init(gen, cfg, dtype=dtype)
        if cfg.sandwich_norm:
            p["norm_ffn_post"] = norm()
    return p


def body_init(gen, cfg: ArchConfig, dtype=torch.float32):
    return {f"sub{i}": _sublayer_init(gen, cfg, s, dtype)
            for i, s in enumerate(body_layout(cfg))}


def stack_drawn(draw, n: int):
    """`n` trees from `draw()` with their leaves stacked on a leading axis:
    drawn one after another, each written into the stacked leaves once it
    is drawn (one tree is stacked as a view)."""
    stacked = None
    for i in range(n):
        one = draw()
        if n == 1:
            return tree_map(lambda x: x.unsqueeze(0), one)
        if stacked is None:
            stacked = tree_map(
                lambda x: x.new_empty((n,) + tuple(x.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, one)
        del one
    return stacked


def lm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
            device=None) -> ParamTree:
    """The reference's parameter tree (bodies stacked on a leading axis; no
    `lm_head` when the embeddings are tied) as a `ParamTree` in `dtype` on
    `resolve_device(device)`.  The values are the float32 draws cast to
    `dtype`."""
    dev = resolve_device(device)
    params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": stack_drawn(lambda: body_init(gen, cfg, dtype),
                              cfg.n_layers // cfg.block_pattern),
        "final_norm": L.norm_init(cfg, cfg.d_model, gen.device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          False, dtype)
    return ParamTree(tree_map(lambda x: x.to(dev), params))


# ---------------------------------------------------------------------------
# state init (prefill/decode caches)
# ---------------------------------------------------------------------------

def _sublayer_state(cfg: ArchConfig, spec: SubLayerSpec, batch: int,
                    max_len: int, dtype, device):
    if spec.kind == "attn":
        # SWA layers only ever hold a window of KV
        eff = min(max_len, spec.window) if spec.window else max_len
        return L.init_kv_cache(cfg, batch, eff, dtype, device)
    if spec.kind == "mamba":
        # float32, whatever the cache dtype: the reference passes none
        return MB.init_mamba_state(cfg, batch, device=device)
    if spec.kind == "mlstm":
        return XL.init_mlstm_state(cfg, batch, device)
    if spec.kind == "slstm":
        return XL.init_slstm_state(cfg, batch, dtype, device)
    raise ValueError(spec.kind)


def init_lm_state(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Stacked per-body decode state (the serving 'KV cache' tree) on
    `resolve_device(device)`: one body's initial state (zeros, and -1e30
    for the xLSTM stabilisers), each leaf in its own dtype, repeated over
    the bodies."""
    dev = resolve_device(device)
    n_bodies = cfg.n_layers // cfg.block_pattern
    one = {f"sub{i}": _sublayer_state(cfg, s, batch, max_len, dtype, dev)
           for i, s in enumerate(body_layout(cfg))}
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (n_bodies,) + (1,) * x.dim()), one)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def sublayer_apply(p, cfg: ArchConfig, spec: SubLayerSpec, x, positions, *,
                   mode: str, state, cache_pos, moe_impl,
                   shard=SH.identity_shard, mesh=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.norm_apply(cfg, p["norm_mix"], x)
    if spec.kind == "attn":
        h, new_state = L.attention_apply(
            p["mix"], cfg, h, positions, layer_window=spec.window, mode=mode,
            cache=state, cache_pos=cache_pos, shard=shard)
    elif spec.kind == "mamba":
        h, new_state = MB.mamba_apply(p["mix"], cfg, h, mode=mode,
                                      state=state, shard=shard)
    elif spec.kind == "mlstm":
        h, new_state = XL.mlstm_block_apply(p["mix"], cfg, h, mode=mode,
                                            state=state, shard=shard)
    elif spec.kind == "slstm":
        h, new_state = XL.slstm_block_apply(p["mix"], cfg, h, mode=mode,
                                            state=state, shard=shard)
    else:
        raise ValueError(spec.kind)
    if cfg.sandwich_norm:
        h = L.norm_apply(cfg, p["norm_mix_post"], h)
    x = x + h

    if spec.ffn is not None:
        h = L.norm_apply(cfg, p["norm_ffn"], x)
        if spec.ffn == "moe":
            if moe_impl == "ep":
                h, aux = MOE.moe_apply_ep(p["ffn"], cfg, h, mesh=mesh)
            elif shard.sc is not None:
                h, aux = MOE.moe_apply_local(p["ffn"], cfg, h, moe_impl,
                                             shard.sc)
            else:
                h, aux = MOE.moe_apply(p["ffn"], cfg, h, impl=moe_impl)
        else:
            h = L.mlp_apply(p["ffn"], cfg, h, shard=shard)
        if cfg.sandwich_norm:
            h = L.norm_apply(cfg, p["norm_ffn_post"], h)
        x = x + h
    return x, new_state, aux


def body_apply(p, cfg: ArchConfig, x, positions, *, mode: str, states=None,
               cache_pos=None, moe_impl: str = "sorted",
               shard=SH.identity_shard, mesh=None):
    new_states = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(body_layout(cfg)):
        st = states[f"sub{i}"] if states is not None else None
        x, nst, a = sublayer_apply(
            p[f"sub{i}"], cfg, spec, x, positions, mode=mode, state=st,
            cache_pos=cache_pos, moe_impl=moe_impl, shard=shard, mesh=mesh)
        new_states[f"sub{i}"] = nst
        aux = aux + a
        x = shard(x, ("batch", "seq", "d_model"))
    return x, new_states, aux


def embed_tokens(params, cfg: ArchConfig, tokens, embeds=None):
    """Token embedding, scaled under `cfg.embed_scale`; a modality
    frontend's embeddings (B, S_img, D) (the vlm stub), cast to the
    tokens' dtype, are prepended along the sequence."""
    x = nn.embed(params["embed"], tokens)
    if cfg.embed_scale:
        # sqrt(d_model) in float32, rounded to the activation dtype first
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        x = x * float(scale.to(x.dtype))
    if embeds is not None:
        # a vocab-sharded lookup's partial sum is reduced before the concat
        x = torch.cat([SH.like(embeds.to(x.dtype), x), SH.reduced(x)], dim=1)
    return x


def lm_head(params, cfg: ArchConfig, x, shard=SH.identity_shard):
    x = L.norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = SH.gather_dim(x, 1) @ params["embed"]["emb"].T
    else:
        logits = nn.dense(params["lm_head"], x)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)
    return shard(logits, ("batch", "seq", "vocab"))


def _store(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Write a decode step's new state leaf into the stacked tree's view
    (an attention cache leaf comes back as that view, already written)."""
    if src is not dst:
        dst.copy_(src)
    return dst


def lm_apply(params, cfg: ArchConfig, tokens, positions, *,
             mode: str = "train", states=None, cache_pos=None,
             moe_impl: str = "sorted", embeds=None,
             return_hidden: bool = False, remat: bool = False,
             shard=SH.identity_shard, mesh=None):
    """tokens (B, S); positions (B, S[, 3]) over the embeds' rows and the
    tokens'.  Returns (logits_or_hidden, new_states, aux), over S_img + S
    rows with `embeds` (B, S_img, D).  In decode mode `states` is updated
    in place and returned.  `return_hidden` skips the final norm and head;
    `remat` (train mode) recomputes each body in the backward pass.
    `shard` / `mesh` are the reference's sharding callback and mesh
    (`distributed/sharding.py`); with them the parameters are DTensors
    and so are the activations."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    params = param_tree(params)
    x = embed_tokens(params, cfg, tokens, embeds)
    x = shard(x, ("batch", "seq", "d_model"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_bodies = cfg.n_layers // cfg.block_pattern

    def train_body(x, p_body):
        y, _, a = body_apply(p_body, cfg, x, positions, mode="train",
                             moe_impl=moe_impl, shard=shard, mesh=mesh)
        return y, a

    per_body = []
    for i in range(n_bodies):
        p_body = _index(params["layers"], i)
        if mode == "train":
            if remat:
                x, a = checkpoint(train_body, x, p_body, use_reentrant=False)
            else:
                x, a = train_body(x, p_body)
            aux = aux + a
            continue
        st = _index(states, i) if mode == "decode" else None
        x, nst, a = body_apply(p_body, cfg, x, positions, mode=mode,
                               states=st, cache_pos=cache_pos,
                               moe_impl=moe_impl, shard=shard, mesh=mesh)
        aux = aux + a
        if mode == "decode":
            tree_map(_store, st, nst)
        else:
            per_body.append(nst)
    if mode == "train":
        new_states = None
    elif mode == "prefill":
        new_states = _stack(per_body)
    else:
        new_states = states
    if return_hidden:
        return x, new_states, aux
    return lm_head(params, cfg, x, shard), new_states, aux
