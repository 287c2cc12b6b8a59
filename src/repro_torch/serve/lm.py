"""Token-LM serving engine — the port of the reference's `serve/lm.py`.

`make_prefill_step` / `make_decode_step` build the step functions;
`ServeEngine` drives them: static-batch greedy generation over fixed
slots, as in the reference.

Differences from the reference, none of which changes a value:

  * Weights are cast to `svc.compute_dtype` once, when the engine is built
    (the reference casts inside its jitted step), and stay on the engine's
    device.
  * The KV cache is allocated once at `max_len` in `svc.cache_dtype`; the
    prefill's K/V are copied into its first S slots (the reference pads
    them to `max_len`), and each decode step writes its slot in place (the
    counterpart of the reference's donated state buffers).
  * `ServeConfig` has no `greedy` and `temperature` fields: the
    reference's steps never read them, and the port, like the reference,
    only takes the argmax.

On the card the prefill runs the hand-written flash-attention and
grouped-matmul kernels, and each decode step the flash-decode kernel.

With a sharding config (`sc`, `distributed/sharding.py`) every rank of
`sc.mesh` runs the engine: the weights are DTensors placed by
`params_shardings`, the KV caches by `state_specs` (each rank holds and
writes its own shard), the activations by the shard callback, and the
kernels run on local shards.  The steps take plain global batches and
return the next tokens as plain global values.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import nn
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.models.lm import param_tree
from repro_torch.models.params import tree_map
from repro_torch.models.registry import Model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024
    cache_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16


def _sharding(sc):
    return (SH.make_shard_fn(sc), sc.mesh) if sc is not None else \
        (SH.identity_shard, None)


def make_prefill_step(model: Model, svc: ServeConfig, sc=None):
    """prefill_step(params, batch) -> (next token (B,) int32, states); the
    params are already in `svc.compute_dtype` (ServeEngine casts once)."""
    shard, mesh = _sharding(sc)

    def prefill_step(params, batch):
        logits, states, _ = model.prefill(params, batch, shard=shard,
                                          mesh=mesh)
        next_tok = SH.full(logits[:, -1]).argmax(dim=-1).to(torch.int32)
        return next_tok, states

    return prefill_step


def make_decode_step(model: Model, svc: ServeConfig, sc=None):
    """decode_step(params, states, batch) -> (next token (B,) int32,
    states); `states` is updated in place."""
    shard, mesh = _sharding(sc)

    def decode_step(params, states, batch):
        logits, states, _ = model.decode(params, batch, states, shard=shard,
                                         mesh=mesh)
        next_tok = SH.full(logits[:, -1]).argmax(dim=-1).to(torch.int32)
        return next_tok, states

    return decode_step


class ServeEngine:
    """Greedy batched generation over fixed slots, on
    `resolve_device(device)`: the card unless the caller passes
    `device="cpu"`; under `sc` on every rank of its mesh."""

    def __init__(self, model: Model, params, svc: ServeConfig, device=None,
                 sc=None):
        self.device = resolve_device(device)
        self.model = model
        self.svc = svc
        self.sc = sc
        dev = self.device
        self.params = tree_map(
            lambda x: x.to(dev),
            nn.cast_floating(param_tree(params), svc.compute_dtype))
        if sc is not None:
            self.params = SH.distribute(
                self.params, SH.params_shardings(self.params, sc), sc.mesh)
        self.prefill_step = make_prefill_step(model, svc, sc)
        self.decode_step = make_decode_step(model, svc, sc)

    def place_states(self, pre_states, batch: int):
        """A zero cache of `max_len` slots in `svc.cache_dtype` with the
        prefill states copied into its first slots."""
        states = self.model.init_state(batch, self.svc.max_len,
                                       self.svc.cache_dtype, self.device)
        if self.sc is not None:
            states = SH.distribute(states, SH.state_specs(states, self.sc),
                                   self.sc.mesh)

        def place(dst, src):
            SH.write_into(dst, SH.full(src).to(dst.dtype))
            return dst
        return tree_map(place, states, pre_states)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 eos_id: int = -1) -> np.ndarray:
        """prompts (B, S) int -> generated ids (B, max_new_tokens) int32."""
        prompts = np.asarray(prompts)
        b, s = prompts.shape
        dev = self.device
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=dev),
                 "positions": torch.arange(s, device=dev).expand(b, s)}
        tok, pre_states = self.prefill_step(self.params, batch)
        states = self.place_states(pre_states, b)
        del pre_states

        out = np.zeros((b, max_new_tokens), np.int32)
        done = np.zeros(b, bool)
        pos = s
        for t in range(max_new_tokens):
            tok_np = tok.cpu().numpy()
            out[:, t] = tok_np
            done |= tok_np == eos_id
            if done.all():
                break
            dec_batch = {
                "tokens": tok[:, None].to(torch.int64),
                "positions": torch.full((b, 1), pos, dtype=torch.int64,
                                        device=dev),
                "cache_pos": torch.full((b,), pos, dtype=torch.int64,
                                        device=dev),
            }
            tok, states = self.decode_step(self.params, states, dec_batch)
            pos += 1
        return out
