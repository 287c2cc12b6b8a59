"""Sorted MoE dispatch + grouped-matmul FFN (ranking-based, PointAcc-style).

The dispatch is the Mapping-Unit step: a stable sort of assignment
expert-ids produces contiguous per-expert segments (maps), capacity-clipped
and padded to the row tile; the grouped matmul kernel consumes them
Fetch-on-Demand.  Integer outputs (`dest_row`, `tile_eid`, `src_token`)
equal the reference's.

  * `make_dispatch`  — expert_idx (T, topk) -> `Dispatch`.
  * `grouped_matmul` — through the CUDA kernel that `grouped_matmul_cuda`
    picks by dtype and shape (its plain version on CPU tensors), as a
    `torch.autograd.Function`: its backward launches the same kernel for
    dX (dY against the transposed weights) and the weight-gradient kernel
    for dW (`grouped_matmul_dw_cuda`), the plain versions on the CPU.
  * `sorted_moe_ffn` — the whole sorted-dispatch expert FFN: three
    `grouped_matmul` calls (w_in, w_gate, w_out) between two masked row
    gathers (`dispatch_gather`: tokens into the sorted rows, rows back to
    the (token, choice) assignments), whose backward is a gather through
    the dispatch's inverse table, not an accumulating scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_matmul.grouped_matmul import (
    grouped_matmul_cuda, grouped_matmul_dw_cuda, grouped_matmul_dx_cuda)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class Dispatch(NamedTuple):
    """Maps from (token, choice) assignments to sorted padded rows."""
    dest_row: torch.Tensor    # (T, topk) int32 row in sorted buffer, -1 drop
    tile_eid: torch.Tensor    # (rows // row_tile,) int32 expert per row tile
    src_token: torch.Tensor   # (rows,) int32 source token per row, -1 pad
    n_rows: int


def make_dispatch(expert_idx: torch.Tensor, n_experts: int,
                  capacity: int, row_tile: int = 128) -> Dispatch:
    """expert_idx (T, topk) -> sorted segment layout.

    capacity = max tokens kept per expert (already row_tile aligned by the
    caller).  Ranking-based: one stable sort over assignments.
    """
    t, topk = expert_idx.shape
    a = t * topk
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).to(torch.int64)
    ar = torch.arange(a, device=dev)

    # Mapping Unit: sort assignments by expert id (stable keeps token order)
    s_e, s_a = torch.sort(flat_e, stable=True)
    s_tok = s_a // topk
    # position within the expert segment
    seg_start = torch.searchsorted(
        s_e, torch.arange(n_experts, device=dev), side="left")
    pos = ar - seg_start[s_e]
    keep = pos < capacity
    dest = torch.where(keep, s_e * capacity + pos, -1)

    # scatter dest back to (token, choice) order
    dest_row = torch.full((a,), -1, dtype=torch.int64, device=dev)
    dest_row[s_a] = dest
    n_rows = n_experts * capacity
    # dropped assignments write into one extra row, cut off after
    src_token = torch.full((n_rows + 1,), -1, dtype=torch.int64, device=dev)
    src_token[torch.where(keep, dest, n_rows)] = s_tok
    tile_eid = torch.arange(n_experts, dtype=torch.int32,
                            device=dev).repeat_interleave(capacity // row_tile)
    return Dispatch(dest_row.reshape(t, topk).to(torch.int32), tile_eid,
                    src_token[:n_rows].to(torch.int32), n_rows)


class _GroupedMatmul(torch.autograd.Function):
    """Forward through the kernel; backward: dX through the same kernel on
    the transposed weights, dW through the weight-gradient kernel.  An
    out-of-range `tile_eid` resolves the same way in all three
    (`ref.expert_ids`), so the gradients are those of the forward as
    computed: what autograd of the plain version gives."""

    @staticmethod
    def forward(ctx, x, tile_eid, weights, row_tile):
        ctx.save_for_backward(x, tile_eid, weights)
        ctx.row_tile = row_tile
        return grouped_matmul_cuda(x, tile_eid, weights, row_tile)

    @staticmethod
    def backward(ctx, dy):
        x, tile_eid, weights = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_dx_cuda(dy, tile_eid, weights, ctx.row_tile)
        if ctx.needs_input_grad[2]:
            dw = grouped_matmul_dw_cuda(x, dy, tile_eid, weights.shape[0],
                                        ctx.row_tile)
        return dx, None, dw, None


def grouped_matmul(x: torch.Tensor, tile_eid: torch.Tensor,
                   weights: torch.Tensor, row_tile: int = 128) -> torch.Tensor:
    """Row tile i of x times weights[tile_eid[i]] -> (R, Cout), with
    gradients for x and weights (see `_GroupedMatmul`)."""
    return _GroupedMatmul.apply(x.contiguous(), tile_eid.contiguous(),
                                weights.contiguous(), row_tile)


def _assignment_of_rows(disp: Dispatch) -> torch.Tensor:
    """The inverse of `disp.dest_row`: (rows, 1) int64, the assignment
    t * topk + k kept in each row, -1 for a padding row.  An integer
    scatter of unique entries (dropped assignments write one extra row,
    cut off)."""
    flat = disp.dest_row.reshape(-1).long()
    out = torch.full((disp.n_rows + 1,), -1, dtype=torch.int64,
                     device=flat.device)
    out[torch.where(flat >= 0, flat, disp.n_rows)] = torch.arange(
        flat.numel(), device=flat.device)
    return out[:disp.n_rows, None]


def _masked_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row idx[...] of src (n, D), zeros where idx < 0 -> idx.shape + (D,)."""
    idx = idx.long()
    return torch.where((idx >= 0)[..., None], src[idx.clamp(min=0)],
                       torch.zeros((), dtype=src.dtype, device=src.device))


class _DispatchGather(torch.autograd.Function):
    """`_masked_rows(src, idx)` whose backward gathers too: `inv` (n, m)
    lists, for each row of src, the flat positions of idx that read it (-1
    for none), so d src[i] = the sum over j of d out.view(-1, D)[inv[i, j]]
    where inv[i, j] >= 0 — the same sums as the scatter that autograd of an
    index would run, taken by a gather and a sum over m, with no atomics and
    no sort."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _masked_rows(src, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        d = _masked_rows(g.reshape(-1, g.shape[-1]), inv).sum(dim=1)
        return d, None, None


def dispatch_gather(src: torch.Tensor, idx: torch.Tensor,
                    inv: torch.Tensor) -> torch.Tensor:
    """where(idx >= 0, src[idx], 0), differentiable in src through the
    inverse table `inv` (see `_DispatchGather`); every flat position of idx
    that reads a row must appear once in that row's line of inv.  `inv`
    may be None where no gradient is asked of src."""
    return _DispatchGather.apply(src, idx, inv)


def sorted_moe_ffn(x: torch.Tensor, expert_idx: torch.Tensor,
                   gates: torch.Tensor, w_in: torch.Tensor,
                   w_out: torch.Tensor, *, capacity_factor: float = 1.25,
                   row_tile: int = 128, act=F.silu,
                   w_gate: torch.Tensor | None = None) -> torch.Tensor:
    """Full sorted-dispatch MoE FFN.

    x (T, D); expert_idx/gates (T, topk); w_in (E, D, F); w_out (E, F, D);
    optional w_gate (E, D, F) for gated (SwiGLU-style) experts.
    """
    t, d = x.shape
    e = w_in.shape[0]
    topk = expert_idx.shape[1]
    capacity = _round_up(int(t * topk * capacity_factor / e) + 1, row_tile)
    disp = make_dispatch(expert_idx, e, capacity, row_tile)

    # tokens into sorted rows; the backward sums each token's rows through
    # dest_row, the inverse of src_token
    xs = dispatch_gather(x, disp.src_token, disp.dest_row)     # (rows, D)
    h = grouped_matmul(xs, disp.tile_eid, w_in, row_tile)
    if w_gate is not None:
        g = grouped_matmul(xs, disp.tile_eid, w_gate, row_tile)
        h = act(g) * h
    else:
        h = act(h)
    y = grouped_matmul(h, disp.tile_eid, w_out, row_tile)      # (rows, D)

    # combine: gather each assignment's row, weight by gate, sum over topk;
    # the backward takes each row's one assignment through src_assign
    src_assign = _assignment_of_rows(disp) if y.requires_grad else None
    picked = dispatch_gather(y, disp.dest_row, src_assign)      # (T, topk, D)
    return (picked * gates[..., None]).sum(dim=1).to(x.dtype)
