"""Plain PyTorch version of the grouped matmul kernel (the reference's
`grouped_matmul_ref`)."""

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
