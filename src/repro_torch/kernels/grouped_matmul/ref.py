"""Plain PyTorch version of the grouped matmul kernel (the reference's
`grouped_matmul_ref`)."""

from __future__ import annotations

import torch


def grouped_matmul_ref(x, tile_eid, weights, row_tile: int = 128):
    """x (R, Cin); tile_eid (R // row_tile,); weights (E, Cin, Cout) ->
    (R, Cout) in x's dtype: row tile i times weights[tile_eid[i]], float32
    products and sums."""
    r, cin = x.shape
    n_tiles = r // row_tile
    xt = x.reshape(n_tiles, row_tile, cin).to(torch.float32)
    wt = weights[tile_eid.long()].to(torch.float32)   # (n_tiles, Cin, Cout)
    out = torch.bmm(xt, wt)
    return out.reshape(r, weights.shape[-1]).to(x.dtype)
