"""Uniform model API — the port of the reference's `models/registry.py`.

build(cfg) -> Model with:
  init(generator, dtype, device=None)       -> params (a ParamTree)
  train_logits(params, batch, remat=False) -> (logits, aux)
  prefill(params, batch)                    -> (logits, states, aux)
  decode(params, batch, states)             -> (logits, states, aux)
  init_state(batch_size, max_len, dtype, device=None) -> decode-state tree
      (the audio family also takes enc_len=, the cross cache's length)
  train_hidden(params, batch, remat=False) -> (final-normed hidden, aux)
  head_info(params)                         -> (head_w, transpose, softcap)

batch dict keys by family:
  lm:    tokens (B,S) positions (B,S) [labels]
  vlm:   + patch_embeds (B,S_img,D), prepended to the token rows;
         positions (B,S_img+S,3) (M-RoPE), or (B,S) (plain RoPE)
  audio: frame_embeds (B,S_enc,D) enc_positions (B,S_enc) tokens (B,S_dec)
         positions (B,S_dec)
decode: tokens (B,1), positions (B,1[,3]), cache_pos (B,).

`params` may be a ParamTree or its nested dict.  Training
(`train/step.py`) goes through `train_logits`, or `train_hidden` +
`head_info` for the chunked cross-entropy; `remat=True` recomputes each
body (each decoder layer) in the backward pass.  Every call takes the
reference's sharding arguments: `shard` (the callback of
`distributed.sharding.make_shard_fn`), `mesh` (the DeviceMesh the
expert-parallel MoE exchanges over) and a per-call `moe_impl` override.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import identity_shard, mesh_axes
from repro_torch.models import encdec as ED
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


def default_moe_impl(cfg: ArchConfig, mode: str, mesh=None) -> str:
    """The reference's rule: "ep" for train and prefill on a mesh whose
    "model" axis has more than one shard, else "sorted" (the
    grouped-matmul kernels; on a mesh, on each rank's local tokens; at a
    model axis of 1 the exchange of "ep" would move nothing), "dense"
    for decode."""
    if not cfg.n_experts:
        return "dense"
    if mesh is not None and mode in ("train", "prefill") and \
            mesh_axes(mesh).get("model", 1) > 1:
        return "ep"
    if mode == "decode":
        return "dense"     # a handful of tokens: G-M-S is optimal here
    return "sorted"


def build(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        return _build_encdec(cfg)
    return _build_lm(cfg)


def _build_lm(cfg: ArchConfig) -> Model:
    def init(gen: torch.Generator, dtype=torch.float32, device=None):
        return LM.lm_init(gen, cfg, dtype, device)

    def train_logits(params, batch, shard=identity_shard, mesh=None,
                     moe_impl=None, remat: bool = False):
        logits, _, aux = LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="train",
            moe_impl=moe_impl or default_moe_impl(cfg, "train", mesh),
            embeds=batch.get("patch_embeds"), remat=remat, shard=shard,
            mesh=mesh)
        return logits, aux

    def train_hidden(params, batch, shard=identity_shard, mesh=None,
                     moe_impl=None, remat: bool = False):
        x, _, aux = LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="train",
            moe_impl=moe_impl or default_moe_impl(cfg, "train", mesh),
            embeds=batch.get("patch_embeds"), remat=remat,
            return_hidden=True, shard=shard, mesh=mesh)
        return L.norm_apply(cfg, LM.param_tree(params)["final_norm"], x), aux

    def head_info(params):
        params = LM.param_tree(params)
        if cfg.tie_embeddings:
            return params["embed"]["emb"], True, cfg.final_softcap
        return params["lm_head"]["w"], False, cfg.final_softcap

    def prefill(params, batch, shard=identity_shard, mesh=None,
                moe_impl=None):
        return LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"],
            mode="prefill",
            moe_impl=moe_impl or default_moe_impl(cfg, "prefill", mesh),
            embeds=batch.get("patch_embeds"), shard=shard, mesh=mesh)

    def decode(params, batch, states, shard=identity_shard, mesh=None,
               moe_impl=None):
        return LM.lm_apply(
            params, cfg, batch["tokens"], batch["positions"], mode="decode",
            states=states, cache_pos=batch["cache_pos"],
            moe_impl=moe_impl or default_moe_impl(cfg, "decode", mesh),
            shard=shard, mesh=mesh)

    def init_state(batch_size, max_len, dtype=torch.bfloat16, device=None):
        return LM.init_lm_state(cfg, batch_size, max_len, dtype, device)

    return Model(cfg, init, train_logits, prefill, decode, init_state,
                 train_hidden, head_info)


def _build_encdec(cfg: ArchConfig) -> Model:
    def init(gen: torch.Generator, dtype=torch.float32, device=None):
        return ED.encdec_init(gen, cfg, dtype, device)

    def train_logits(params, batch, shard=identity_shard, mesh=None,
                     moe_impl=None, remat: bool = False):
        logits, _, aux = ED.encdec_apply(
            params, cfg, batch["frame_embeds"], batch["enc_positions"],
            batch["tokens"], batch["positions"], mode="train", remat=remat,
            shard=shard)
        return logits, aux

    def train_hidden(params, batch, shard=identity_shard, mesh=None,
                     moe_impl=None, remat: bool = False):
        # encdec_apply's hidden states are final-normed already
        x, _, aux = ED.encdec_apply(
            params, cfg, batch["frame_embeds"], batch["enc_positions"],
            batch["tokens"], batch["positions"], mode="train", remat=remat,
            return_hidden=True, shard=shard)
        return x, aux

    def head_info(params):
        return LM.param_tree(params)["lm_head"]["w"], False, None

    def prefill(params, batch, shard=identity_shard, mesh=None,
                moe_impl=None):
        return ED.encdec_apply(
            params, cfg, batch["frame_embeds"], batch["enc_positions"],
            batch["tokens"], batch["positions"], mode="prefill",
            shard=shard)

    def decode(params, batch, states, shard=identity_shard, mesh=None,
               moe_impl=None):
        return ED.encdec_apply(
            params, cfg, None, None, batch["tokens"], batch["positions"],
            mode="decode", states=states, cache_pos=batch["cache_pos"],
            shard=shard)

    def init_state(batch_size, max_len, dtype=torch.bfloat16, device=None,
                   enc_len=None):
        return ED.init_encdec_state(cfg, batch_size, max_len, dtype, device,
                                    enc_len)

    return Model(cfg, init, train_logits, prefill, decode, init_state,
                 train_hidden, head_info)
