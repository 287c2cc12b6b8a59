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
    `grouped_matmul` calls (w_in, w_gate, w_out).
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

    src = disp.src_token.long()
    xs = torch.where((src >= 0)[:, None], x[src.clamp(min=0)],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    h = grouped_matmul(xs, disp.tile_eid, w_in, row_tile)
    if w_gate is not None:
        g = grouped_matmul(xs, disp.tile_eid, w_gate, row_tile)
        h = act(g) * h
    else:
        h = act(h)
    y = grouped_matmul(h, disp.tile_eid, w_out, row_tile)      # (rows, D)

    # combine: gather each assignment's row, weight by gate, sum over topk
    dest = disp.dest_row.long()
    picked = torch.where((dest >= 0)[..., None], y[dest.clamp(min=0)],
                         torch.zeros((), dtype=y.dtype, device=y.device))
    return (picked * gates[..., None]).sum(dim=1).to(x.dtype)
