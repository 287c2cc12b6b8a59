"""GPipe-style pipeline parallelism over the `pod` mesh axis — the port of
the reference's `distributed/pipeline.py`.

The cross-pod links are the slowest in the system; pipelining over them
sends only the (microbatch, seq, d_model) boundary activations instead of
a full gradient all-reduce a step.

Each rank of the `pod` axis is one stage and holds its chunk of the
stacked body parameters (`split_stages`).  GPipe schedule: n_micro +
n_stages - 1 ticks; at tick t stage s runs microbatch t - s (if any) and
hands its output to stage s + 1 (`ppermute`, a send / recv pair whose
backward is the reverse permute, as jax transposes `ppermute`).  Stage 0
reads x, the last stage records its outputs, and a masked all-reduce
broadcasts them to every stage (its backward is the identity, the
transpose of the reference's `psum` of a replicated result).  The whole
schedule is differentiable: the backward runs the reverse pipeline.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import flatten_tree, tree_map


def _p2p(send, send_to, recv_like, recv_from, group):
    """Send `send` to group rank `send_to` and receive a tensor shaped as
    `recv_like` from `recv_from` (either may be None); the received
    tensor, or zeros when nothing is received."""
    ops, out = [], torch.zeros_like(recv_like)
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _ShiftNext(torch.autograd.Function):
    """ppermute over [(i, i + 1)]: stage i's tensor goes to stage i + 1;
    stage 0 receives zeros.  Backward: the reverse permute.  `anchor` (a
    scalar that requires grad) puts the node in every stage's graph at
    every tick, so the stages' backward sends and receives pair up."""

    @staticmethod
    def forward(ctx, x, anchor, group):
        ctx.group = group
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.me, ctx.n = me, n
        return _p2p(x, me + 1 if me + 1 < n else None, x,
                    me - 1 if me > 0 else None, group)

    @staticmethod
    def backward(ctx, g):
        me, n = ctx.me, ctx.n
        return _p2p(g, me - 1 if me > 0 else None, g,
                    me + 1 if me + 1 < n else None, ctx.group), \
            torch.zeros(()), None


class _SumToAll(torch.autograd.Function):
    """all_reduce(sum) whose result every stage holds as one replicated
    value: its backward passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(body_fn: Callable, stage_params, x, n_micro: int,
                   group=None):
    """Run a stack of bodies as a pipeline over the ranks of `group` (the
    `pod` axis's process group).

    body_fn(params_one_body, x) -> x      (one body)
    stage_params: this stage's stacked body params, leading dim =
                  bodies_per_stage.
    x: (n_micro, micro_batch, ...) microbatched input (stage 0 reads it).
    Returns (n_micro, micro_batch, ...) outputs of the last stage, on every
    stage.
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_ticks = n_micro + n_stages - 1
    n_bodies = next(flatten_tree(stage_params))[1].shape[0]

    def stage_fwd(h):
        for i in range(n_bodies):
            h = body_fn(tree_map(lambda a: a[i], stage_params), h)
        return h

    grad = torch.is_grad_enabled()
    anchor = torch.zeros((), requires_grad=grad)
    sink = torch.zeros((), dtype=x.dtype, device=x.device)
    inbuf = torch.zeros_like(x[0])
    outputs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
    for t in range(n_ticks):
        mb = t - stage                       # microbatch this stage runs
        if 0 <= mb < n_micro:
            out = stage_fwd(x[mb] if stage == 0 else inbuf)
            if stage == n_stages - 1:
                outputs[mb] = out
        else:
            out = torch.zeros_like(x[0])
        inbuf = _ShiftNext.apply(out, anchor, group)
        if grad:   # every permute's result reaches the output (times 0)
            sink = sink + inbuf.sum() * 0
    # broadcast the last stage's outputs to every stage (masked sum)
    return _SumToAll.apply(torch.stack(outputs), group) + sink


def split_stages(stacked_params, n_stages: int):
    """Split stacked body params into per-stage chunks along dim 0: a new
    leading stage dim."""
    def split(x):
        nb = x.shape[0]
        if nb % n_stages:
            raise ValueError(f"{nb} bodies do not split into {n_stages} "
                             "stages")
        return x.reshape((n_stages, nb // n_stages) + tuple(x.shape[1:]))
    return tree_map(split, stacked_params)


def pipelined_forward(body_fn, params_layers, x, mesh, n_micro: int = 4):
    """Pipeline over the mesh's `pod` axis: each rank runs its stage's
    chunk of `params_layers` (the global stacked params, the same on every
    rank).  x: (B, S, D), the same on every rank, microbatched internally
    along batch.  Returns the (B, S, D) output on every rank."""
    group = mesh.get_group("pod")
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    staged = tree_map(lambda a: a[stage],
                      split_stages(params_layers, n_stages))
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    out = pipeline_apply(body_fn, staged, xm, n_micro, group)
    return out.reshape(x.shape)
