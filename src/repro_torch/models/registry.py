"""Uniform model API — the port of the reference's `models/registry.py`,
for the LM family (the encoder-decoder `audio` family is not ported).

build(cfg) -> Model with:
  init(generator, dtype, device=None)       -> params (a ParamTree)
  train_logits(params, batch)               -> (logits, aux)
  prefill(params, batch)                    -> (logits, states, aux)
  decode(params, batch, states)             -> (logits, states, aux)
  init_state(batch_size, max_len, dtype, device=None) -> decode-state tree

batch dict keys: tokens (B,S) positions (B,S); decode: tokens (B,1),
positions (B,1), cache_pos (B,).  `params` may be a ParamTree or its
nested dict.  The reference's sharding arguments (`shard`, `mesh`), its
per-call `moe_impl` overrides, its `patch_embeds` input and its training
helpers (`train_hidden`, `head_info`) are not ported: the port serves on
one card and does not train yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as LM


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    train_logits: Callable
    prefill: Callable
    decode: Callable
    init_state: Callable


def default_moe_impl(cfg: ArchConfig, mode: str) -> str:
    if not cfg.n_experts:
        return "dense"
    if mode == "decode":
        return "dense"     # a handful of tokens: G-M-S is optimal here
    return "sorted"


def build(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        raise NotImplementedError(
            "the encoder-decoder (audio) family is not ported yet: ROADMAP "
            "A.11")
    return _build_lm(cfg)


def _build_lm(cfg: ArchConfig) -> Model:
    def init(gen: torch.Generator, dtype=torch.float32, device=None):
        return LM.lm_init(gen, cfg, dtype, device)

    def train_logits(params, batch):
        logits, _, aux = LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="train",
            moe_impl=default_moe_impl(cfg, "train"))
        return logits, aux

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

    return Model(cfg, init, train_logits, prefill, decode, init_state)
