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
place: the counterpart of the reference's donated buffers).  Only
attention bodies are ported, with dense (gated or plain) or MoE FFNs, QKV
bias, sliding windows, RMSNorm, RoPE and an untied head: what
granite-moe-1b-a400m, qwen1.5-4b / 32b, granite-34b and mixtral-8x7b
need.  `check_ported` raises NotImplementedError for the reference's other
features (mamba/xLSTM layouts, M-RoPE, sandwich and local/global norms,
embedding scale, tied embeddings, final softcap, layernorm).

`lm_init(generator, cfg, dtype, device=None)` draws the reference's shapes
and distributions from a `torch.Generator` (on the generator's device) and
returns a `ParamTree` on `resolve_device(device)`: the card unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.params import ParamTree, tree_map


class SubLayerSpec(NamedTuple):
    kind: str               # attn (the reference also has mamba/mlstm/slstm)
    ffn: Optional[str]      # dense | moe | None
    window: Optional[int]   # per-layer attention window


# config features the reference's LM code has and the port does not run yet;
# each comes back with the slice that registers a config needing it
_UNPORTED_FLAGS = ("mrope", "sandwich_norm", "local_global", "embed_scale",
                   "tie_embeddings")


def check_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a config the port cannot run."""
    if cfg.ssm_type is not None:
        raise NotImplementedError(
            f"{cfg.ssm_type} sub-layers are not ported yet (ROADMAP Queue A "
            "item 5): "
            "only attention bodies run in repro_torch")
    found = [f for f in _UNPORTED_FLAGS if getattr(cfg, f)]
    if cfg.final_softcap is not None:
        found.append("final_softcap")
    if cfg.norm != "rmsnorm":
        found.append(f"norm={cfg.norm!r}")
    if found:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(found)} not ported yet (ROADMAP Queue A "
            "item 5)")


def body_layout(cfg: ArchConfig):
    """Static description of one body (cfg.block_pattern sub-layers)."""
    check_ported(cfg)
    subs = []
    for i in range(cfg.block_pattern):
        if cfg.n_experts:
            ffn = "moe" if i % cfg.moe_every == cfg.moe_every - 1 else \
                "dense"
        else:
            ffn = "dense" if cfg.d_ff else None
        subs.append(SubLayerSpec("attn", ffn, cfg.sliding_window))
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

def _sublayer_init(gen, cfg: ArchConfig, spec: SubLayerSpec):
    p: dict = {"norm_mix": L.norm_init(cfg, cfg.d_model, gen.device),
               "mix": L.attention_init(gen, cfg)}
    if spec.ffn is not None:
        p["norm_ffn"] = L.norm_init(cfg, cfg.d_model, gen.device)
        if spec.ffn == "moe":
            p["ffn"] = MOE.moe_init(gen, cfg)
        else:
            p["ffn"] = L.mlp_init(gen, cfg)
    return p


def body_init(gen, cfg: ArchConfig):
    return {f"sub{i}": _sublayer_init(gen, cfg, s)
            for i, s in enumerate(body_layout(cfg))}


def lm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
            device=None) -> ParamTree:
    """The reference's parameter tree (bodies stacked on a leading axis) as
    a `ParamTree` in `dtype` on `resolve_device(device)`."""
    dev = resolve_device(device)
    n_bodies = cfg.n_layers // cfg.block_pattern
    params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "layers": _stack([body_init(gen, cfg) for _ in range(n_bodies)]),
        "final_norm": L.norm_init(cfg, cfg.d_model, gen.device),
        "lm_head": nn.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                 use_bias=False),
    }
    params = tree_map(lambda x: x.to(dev), nn.cast_floating(params, dtype))
    return ParamTree(params)


# ---------------------------------------------------------------------------
# state init (prefill/decode caches)
# ---------------------------------------------------------------------------

def _sublayer_state(cfg: ArchConfig, spec: SubLayerSpec, batch: int,
                    max_len: int, dtype, device):
    # SWA layers only ever hold a window of KV
    eff = min(max_len, spec.window) if spec.window else max_len
    return L.init_kv_cache(cfg, batch, eff, dtype, device)


def init_lm_state(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Stacked per-body decode state (the serving 'KV cache' tree), zeros
    on `resolve_device(device)`."""
    dev = resolve_device(device)
    n_bodies = cfg.n_layers // cfg.block_pattern
    one = {f"sub{i}": _sublayer_state(cfg, s, batch, max_len, dtype, dev)
           for i, s in enumerate(body_layout(cfg))}
    return tree_map(
        lambda x: torch.zeros((n_bodies,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), one)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def sublayer_apply(p, cfg: ArchConfig, spec: SubLayerSpec, x, positions, *,
                   mode: str, state, cache_pos, moe_impl):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.norm_apply(cfg, p["norm_mix"], x)
    h, new_state = L.attention_apply(
        p["mix"], cfg, h, positions, layer_window=spec.window, mode=mode,
        cache=state, cache_pos=cache_pos)
    x = x + h

    if spec.ffn is not None:
        h = L.norm_apply(cfg, p["norm_ffn"], x)
        if spec.ffn == "moe":
            h, aux = MOE.moe_apply(p["ffn"], cfg, h, impl=moe_impl)
        else:
            h = L.mlp_apply(p["ffn"], cfg, h)
        x = x + h
    return x, new_state, aux


def body_apply(p, cfg: ArchConfig, x, positions, *, mode: str, states=None,
               cache_pos=None, moe_impl: str = "sorted"):
    new_states = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(body_layout(cfg)):
        st = states[f"sub{i}"] if states is not None else None
        x, nst, a = sublayer_apply(
            p[f"sub{i}"], cfg, spec, x, positions, mode=mode, state=st,
            cache_pos=cache_pos, moe_impl=moe_impl)
        new_states[f"sub{i}"] = nst
        aux = aux + a
    return x, new_states, aux


def embed_tokens(params, cfg: ArchConfig, tokens):
    return nn.embed(params["embed"], tokens)


def lm_head(params, cfg: ArchConfig, x):
    x = L.norm_apply(cfg, params["final_norm"], x)
    return nn.dense(params["lm_head"], x)


def lm_apply(params, cfg: ArchConfig, tokens, positions, *,
             mode: str = "train", states=None, cache_pos=None,
             moe_impl: str = "sorted", return_hidden: bool = False,
             remat: bool = False):
    """tokens (B, S); positions (B, S[, 3]).  Returns (logits_or_hidden,
    new_states, aux).  In decode mode `states` is updated in place and
    returned.  `return_hidden` skips the final norm and head; `remat`
    (train mode) recomputes each body in the backward pass."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    check_ported(cfg)
    params = param_tree(params)
    x = embed_tokens(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_bodies = cfg.n_layers // cfg.block_pattern

    def train_body(x, p_body):
        y, _, a = body_apply(p_body, cfg, x, positions, mode="train",
                             moe_impl=moe_impl)
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
                               moe_impl=moe_impl)
        aux = aux + a
        per_body.append(nst)
    if mode == "train":
        new_states = None
    elif mode == "prefill":
        new_states = _stack(per_body)
    else:
        new_states = states
    if return_hidden:
        return x, new_states, aux
    return lm_head(params, cfg, x), new_states, aux
