"""Mixture-of-Experts with PointAcc-style ranking-based dispatch — the port
of the reference's `models/moe.py`.

  * `dense`  — Gather-MatMul-Scatter baseline: every token through every
    expert, one-hot combine (plain products; the decode step's default).
  * `sorted` — single-shard Fetch-on-Demand: assignments sorted by expert
    (Mapping Unit), grouped matmul over contiguous segments through the
    hand-written kernel (`kernels/grouped_matmul`; the default of the
    prefill and of training, whose backward runs the kernel for dX and the
    weight-gradient kernel for dW).
  * `ep`     — the sharded expert-parallel version: not ported yet
    (ROADMAP Queue A item 6).

The aux load-balance loss (Switch-style) is returned alongside.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.grouped_matmul import ops as gmm
from repro_torch.models.layers import act_fn


def moe_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, dtype=torch.float32):
    d, f, e = cfg.d_model, d_ff or cfg.d_ff, cfg.n_experts
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f)
    p = {
        "router": nn.dense_init(gen, d, e, False, dtype),
        "w_in": nn.uniform_init(gen, (e, d, f), scale_in, dtype),
        "w_out": nn.uniform_init(gen, (e, f, d), scale_out, dtype),
    }
    if cfg.gated_mlp:
        p["w_gate"] = nn.uniform_init(gen, (e, d, f), scale_in, dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: a comparison, so no host sync (`F.one_hot` checks
    the index range on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(p, cfg: ArchConfig, x2d: torch.Tensor):
    """x2d (T, D) -> (gates (T, topk), expert_idx (T, topk), aux_loss).

    The top-k is taken by a stable descending sort, so tied probabilities
    rank lowest expert first, as `lax.top_k` does (`torch.topk` promises
    no order among ties)."""
    logits = nn.dense(p["router"], x2d).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt[:, :cfg.topk], order[:, :cfg.topk]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-style aux loss: E * sum_e f_e * P_e
    e = cfg.n_experts
    hard = _one_hot(idx, e, torch.float32).sum(dim=1)           # (T, E)
    f_e = hard.mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = e * (f_e * p_e).sum()
    return gates.to(x2d.dtype), idx, aux


# ---------------------------------------------------------------------------
# dense baseline (Gather-MatMul-Scatter analogue)
# ---------------------------------------------------------------------------

def moe_apply_dense(p, cfg: ArchConfig, x: torch.Tensor):
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, aux = route(p, cfg, x2)
    act = act_fn(cfg.act)
    h = torch.einsum("td,edf->tef", x2, p["w_in"])
    if "w_gate" in p:
        h = act(torch.einsum("td,edf->tef", x2, p["w_gate"])) * h
    else:
        h = act(h)
    y = torch.einsum("tef,efd->ted", h, p["w_out"])
    onehot = _one_hot(idx, cfg.n_experts, gates.dtype) * gates[..., None]
    out = torch.einsum("tke,ted->td", onehot, y)
    return out.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# single-shard sorted dispatch (Fetch-on-Demand)
# ---------------------------------------------------------------------------

def moe_apply_sorted(p, cfg: ArchConfig, x: torch.Tensor,
                     capacity_factor: float = 1.5, row_tile: int = 128):
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    gates, idx, aux = route(p, cfg, x2)
    out = gmm.sorted_moe_ffn(
        x2, idx, gates, p["w_in"], p["w_out"],
        w_gate=p.get("w_gate"), capacity_factor=capacity_factor,
        row_tile=row_tile, act=act_fn(cfg.act))
    return out.reshape(b, s, d), aux


def moe_apply_ep(*args, **kwargs):
    raise NotImplementedError(
        "moe_apply_ep (sharded expert parallelism) is not ported yet: "
        "ROADMAP Queue A item 6")


def moe_apply(p, cfg, x, impl: str = "sorted", **kw):
    if impl == "dense":
        return moe_apply_dense(p, cfg, x)
    if impl == "sorted":
        return moe_apply_sorted(p, cfg, x, **kw)
    if impl == "ep":
        return moe_apply_ep(p, cfg, x, **kw)
    raise ValueError(impl)
