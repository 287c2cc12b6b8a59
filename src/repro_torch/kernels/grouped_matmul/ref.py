"""Plain PyTorch versions of the grouped matmul kernels: the forward (the
reference's `grouped_matmul_ref`) and its weight gradient."""

from __future__ import annotations

import torch


def expert_ids(tile_eid, n_experts: int):
    """tile_eid as int64 expert indices in [0, n_experts - 1] by the
    reference's rule (jnp indexing): wrap a negative id once, then clamp.
    The CUDA kernels apply the same rule."""
    eid = tile_eid.long()
    return torch.where(eid < 0, eid + n_experts, eid).clamp(0, n_experts - 1)


def grouped_matmul_ref(x, tile_eid, weights, row_tile: int = 128):
    """x (R, Cin); tile_eid (R // row_tile,); weights (E, Cin, Cout) ->
    (R, Cout) in x's dtype: row tile i times weights[tile_eid[i]], float32
    products and sums; an id out of range is taken by `expert_ids`."""
    r, cin = x.shape
    n_tiles = r // row_tile
    xt = x.reshape(n_tiles, row_tile, cin).to(torch.float32)
    wt = weights[expert_ids(tile_eid, weights.shape[0])].to(torch.float32)
    out = torch.bmm(xt, wt)
    return out.reshape(r, weights.shape[-1]).to(x.dtype)


def grouped_matmul_dw_ref(x, dy, tile_eid, n_experts: int,
                          row_tile: int = 128):
    """x (R, Cin); dy (R, Cout); tile_eid (R // row_tile,) -> dW (E, Cin,
    Cout) in x's dtype: dW[e] = sum of x_i^T dy_i over the row tiles i
    whose expert (by `expert_ids`) is e, float32 products and sums; an
    expert that owns no tile gets zeros."""
    r, cin = x.shape
    n_tiles = r // row_tile
    xt = x.reshape(n_tiles, row_tile, cin).to(torch.float32)
    dyt = dy.reshape(n_tiles, row_tile, dy.shape[-1]).to(torch.float32)
    per_tile = torch.bmm(xt.transpose(1, 2), dyt)
    out = torch.zeros((n_experts, cin, dy.shape[-1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, expert_ids(tile_eid, n_experts), per_tile)
    return out.to(x.dtype)
