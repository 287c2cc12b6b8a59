"""Mixture-of-Experts with PointAcc-style ranking-based dispatch — the port
of the reference's `models/moe.py`.

  * `dense`  — Gather-MatMul-Scatter baseline: every token through every
    expert, one-hot combine (plain products; the decode step's default).
  * `sorted` — single-shard Fetch-on-Demand: assignments sorted by expert
    (Mapping Unit), grouped matmul over contiguous segments through the
    hand-written kernel (`kernels/grouped_matmul`; the default of the
    prefill and of training, whose backward runs the kernel for dX and the
    weight-gradient kernel for dW).
  * `ep`     — the sharded expert-parallel version (`moe_apply_ep`):
    tokens are ranked into per-destination-shard segments
    (`make_ep_dispatch`), exchanged with one `all_to_all_single` over the
    `model` mesh axis, processed by the local expert(s) as plain matmuls
    and returned by the inverse exchange.  Supports E % ep == 0 and
    ep % E == 0 (experts replicated r = ep / E times).

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


# ---------------------------------------------------------------------------
# sharded expert parallelism (all_to_all over the `model` mesh axis)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def make_ep_dispatch(expert_idx: torch.Tensor, n_experts: int, ep: int,
                     cap_per_slot: int):
    """Rank assignments into (shard, local-slot, position) coordinates.

    n_slots = max(E, ep).  E >= ep: slot == expert (E/ep slots per shard).
    E < ep: each expert owns r = ep/E consecutive slots and its
    assignments round-robin across them (balanced by position parity).
    Returns int32 (dest_row, src_token):
      dest_row (T, topk): row in the flattened (n_slots * C) send buffer,
        -1 for capacity-dropped assignments;
      src_token (n_slots * C,): source token per buffer row (-1 = padding),
        so the send buffer is built by a gather.
    """
    t, topk = expert_idx.shape
    a = t * topk
    dev = expert_idx.device
    r = max(1, ep // n_experts)
    n_rows = max(n_experts, ep) * cap_per_slot
    flat_e = expert_idx.reshape(-1).to(torch.int64)
    s_e, s_a = torch.sort(flat_e, stable=True)
    seg_start = torch.searchsorted(
        s_e, torch.arange(n_experts, device=dev), side="left")
    pos = torch.arange(a, device=dev) - seg_start[s_e]
    slot = s_e * r + pos % r
    pos_slot = pos // r
    keep = pos_slot < cap_per_slot
    dest = torch.where(keep, slot * cap_per_slot + pos_slot, -1)
    dest_row = torch.full((a,), -1, dtype=torch.int64, device=dev)
    dest_row[s_a] = dest
    # dropped assignments write to a row past the end, then cut off
    src_token = torch.full((n_rows + 1,), -1, dtype=torch.int64, device=dev)
    src_token[torch.where(keep, dest, n_rows)] = s_a // topk
    return (dest_row.reshape(t, topk).to(torch.int32),
            src_token[:n_rows].to(torch.int32))


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times `k` in backward."""
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def moe_apply_ep(p, cfg: ArchConfig, x, *, mesh, model_axis: str = "model",
                 data_spec=None, capacity_factor: float = 1.5,
                 token_sharded: bool = True):
    """x (B, S, D) (a DTensor, or the same global tensor on every rank)
    with batch sharded over the data axes.

    Runs on local shards (`sharding.local_call`): the only communication
    is one `all_to_all_single` out over `model_axis` and one back; the
    load-balance loss is averaged over the shards.  The local expert
    products are plain matmuls, as in the reference.  token_sharded: the
    seq dim also shards over the model axis, so each rank routes only its
    own tokens.  Without it the tokens are replicated over the model axis
    and every rank dispatches the same ones: their gradients are scaled
    by 1/ep so the duplicates sum to one.
    """
    import torch.distributed.nn.functional as dnn
    from repro_torch.distributed import sharding as SH

    axes = SH.mesh_axes(mesh)
    ep = axes[model_axis]
    e = cfg.n_experts
    if not (e % ep == 0 or ep % e == 0):
        raise ValueError(f"{e} experts cannot be split over {ep} shards")
    epl = max(1, e // ep)           # local experts per shard
    r = max(1, ep // e)
    b, s, d = x.shape
    if data_spec is None:
        data_spec = tuple(a for a in ("pod", "data") if a in axes)
    n_data = 1
    for a in SH.axis_names(data_spec):
        n_data *= axes[a]
    if b % n_data != 0:
        # batch not shardable over data: tokens replicated over data
        data_spec, n_data = None, 1
    token_sharded = token_sharded and s % ep == 0
    seq_spec = model_axis if token_sharded else None
    n_seq = ep if token_sharded else 1
    t_loc = (b // n_data) * (s // n_seq)
    n_slots = max(e, ep)
    cap = _round_up(int(t_loc * cfg.topk * capacity_factor / n_slots) + 1, 8)
    group = mesh.get_group(model_axis)
    me = mesh.get_local_rank(model_axis)
    gated = "w_gate" in p
    act = act_fn(cfg.act)

    def exchange(t):
        return dnn.all_to_all_single(torch.empty_like(t), t.contiguous(),
                                     group=group)

    def local_fn(xl, router_w, w_in, w_gate, w_out):
        bl, sl = xl.shape[0], xl.shape[1]
        if ep > e:                  # replicated experts: this shard's copy
            w_in, w_gate, w_out = (None if w is None else w[me // r][None]
                                   for w in (w_in, w_gate, w_out))
        x2 = xl.reshape(-1, d)
        gates, idx, aux = route({"router": {"w": router_w}}, cfg, x2)
        dest, src_token = make_ep_dispatch(idx, e, ep, cap)
        dest, src_token = dest.long(), src_token.long()
        send = torch.where(src_token[:, None] >= 0,
                           x2[src_token.clamp(min=0)], 0)
        recv = exchange(send.reshape(ep, epl * cap, d))
        recv = recv.reshape(ep, epl, cap, d)
        outs = []
        for le in range(epl):
            rows = recv[:, le].reshape(ep * cap, d)          # one expert
            h = rows @ w_in[le]
            if gated:
                h = act(rows @ w_gate[le]) * h
            else:
                h = act(h)
            outs.append((h @ w_out[le]).reshape(ep, cap, d))
        back = torch.stack(outs, dim=1).reshape(ep, epl * cap, d)
        ret = exchange(back).reshape(n_slots * cap, d)
        picked = torch.where(dest[..., None] >= 0,
                             ret[dest.clamp(min=0)], 0.0)   # (T, topk, D)
        out = (picked * gates[..., None]).sum(dim=1)
        out = out.reshape(bl, sl, d).to(xl.dtype)
        if not token_sharded:
            out = _ScaleGrad.apply(out, 1.0 / ep)
        return out, aux.reshape(1)

    w_spec = () if ep > e else (model_axis, None, None)
    x_spec = (data_spec, seq_spec, None)
    split = tuple(SH.axis_names(data_spec)) + (model_axis,)
    out, aux = SH.local_call(
        local_fn, (x, p["router"]["w"], p["w_in"], p.get("w_gate"),
                   p["w_out"]),
        (x_spec, (), w_spec, w_spec if gated else None, w_spec),
        [x_spec, (split,)], mesh, grad_partial=split)
    return out, aux.mean()


def moe_apply_local(p, cfg: ArchConfig, x, impl: str, sc):
    """`moe_apply(impl)` under a sharding config, on each rank's local
    tokens (batch over the data axes; weights gathered): the sorted
    dispatch's grouped-matmul kernels run on local tensors.  The
    load-balance loss is the mean of the shards' (the reference's EP
    rule)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.params import flatten_tree
    data = sc.data_spec if SH.divides(x.shape[0], sc.n_data) else None
    paths, leaves = zip(*flatten_tree(p))

    def local_fn(xl, *ws):
        tree: dict = {}
        for path, w in zip(paths, ws):
            *parents, leaf = path.split(".")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = w
        out, aux = moe_apply(tree, cfg, xl, impl=impl)
        return out, aux.reshape(1)

    x_spec = (data, None, None)
    out, aux = SH.local_call(
        local_fn, (x, *leaves), (x_spec,) + ((),) * len(leaves),
        [x_spec, (data,)], sc.mesh, grad_partial=SH.axis_names(data))
    return out, aux.mean()


def moe_apply(p, cfg, x, impl: str = "sorted", **kw):
    if impl == "dense":
        return moe_apply_dense(p, cfg, x)
    if impl == "sorted":
        return moe_apply_sorted(p, cfg, x, **kw)
    if impl == "ep":
        return moe_apply_ep(p, cfg, x, **kw)
    raise ValueError(impl)
