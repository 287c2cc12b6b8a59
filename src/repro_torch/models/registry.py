"""Uniform model API — the port of the reference's `models/registry.py`,
for the LM family (the encoder-decoder `audio` family is not ported).

build(cfg) -> Model with:
  init(generator, dtype, device=None)       -> params (a ParamTree)
  train_logits(params, batch, remat=False) -> (logits, aux)
  prefill(params, batch)                    -> (logits, states, aux)
  decode(params, batch, states)             -> (logits, states, aux)
  init_state(batch_size, max_len, dtype, device=None) -> decode-state tree
  train_hidden(params, batch, remat=False) -> (final-normed hidden, aux)
  head_info(params)                         -> (head_w, transpose, softcap)

batch dict keys: tokens (B,S) positions (B,S); decode: tokens (B,1),
positions (B,1), cache_pos (B,).  `params` may be a ParamTree or its
nested dict.  Training (`train/step.py`) goes through `train_logits`, or
`train_hidden` + `head_info` for the chunked cross-entropy; `remat=True`
recomputes each body in the backward pass.  The reference's sharding
arguments (`shard`, `mesh`; ROADMAP Queue A item 6), its per-call
`moe_impl` overrides and its `patch_embeds` input are not ported: the
port runs on one card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import lm as LM


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    train_logits: Callable
    prefill: Callable
    decode: Callable
    init_state: Callable
    train_hidden: Callable     # final-normed hidden states (for chunked CE)
    head_info: Callable        # params -> (head_w, transpose, softcap)


def default_moe_impl(cfg: ArchConfig, mode: str) -> str:
    """The reference's rule on one device: "sorted" for train and prefill
    (the grouped-matmul kernels), "dense" for decode."""
    if not cfg.n_experts:
        return "dense"
    if mode == "decode":
        return "dense"     # a handful of tokens: G-M-S is optimal here
    return "sorted"


def build(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        raise NotImplementedError(
            "the encoder-decoder (audio) family is not ported yet: ROADMAP "
            "Queue A item 5")
    return _build_lm(cfg)


def _build_lm(cfg: ArchConfig) -> Model:
    def init(gen: torch.Generator, dtype=torch.float32, device=None):
        return LM.lm_init(gen, cfg, dtype, device)

    def train_logits(params, batch, remat: bool = False):
        logits, _, aux = LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="train",
            moe_impl=default_moe_impl(cfg, "train"),
            remat=remat)
        return logits, aux

    def train_hidden(params, batch, remat: bool = False):
        x, _, aux = LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="train",
            moe_impl=default_moe_impl(cfg, "train"),
            remat=remat, return_hidden=True)
        return L.norm_apply(cfg, LM.param_tree(params)["final_norm"], x), aux

    def head_info(params):
        params = LM.param_tree(params)
        if cfg.tie_embeddings:
            return params["embed"]["emb"], True, cfg.final_softcap
        return params["lm_head"]["w"], False, cfg.final_softcap

    def prefill(params, batch):
        return LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"],
            mode="prefill", moe_impl=default_moe_impl(cfg, "prefill"))

    def decode(params, batch, states):
        return LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="decode",
            states=states, cache_pos=batch["cache_pos"],
            moe_impl=default_moe_impl(cfg, "decode"))

    def init_state(batch_size, max_len, dtype=torch.bfloat16, device=None):
        return LM.init_lm_state(cfg, batch_size, max_len, dtype, device)

    return Model(cfg, init, train_logits, prefill, decode, init_state,
                 train_hidden, head_info)
