"""KernelMaps -> inverse table -> kernel call.

  * `sparse_conv_fod`   — `flow="cuda"`: the baseline kernel.
  * `sparse_conv_fused` — `flow="cuda_fused"`: the kernel with the
    `core.sparseconv.Epilogue` folded into its flush.

Unlike the TPU wrappers these pad nothing: the CUDA kernel masks ragged
row tiles, odd Cin and odd Cout itself.  `window_schedule` is the
reference's per-tile feature-window plan, a planning function here: the
CUDA kernels do not take it.
"""

from __future__ import annotations

import torch

from repro_torch.core.mapping import KernelMaps
from repro_torch.core.sparseconv import Epilogue
from repro_torch.kernels.spconv.spconv import (spconv_fod_cuda,
                                               spconv_fod_fused_cuda)


def invert_maps(maps: KernelMaps, out_cap: int) -> torch.Tensor:
    """(K, cap) map lists -> (K, out_cap) int32 inverse table inv[k, j] = i.

    v2 maps carry the table already (`inv`, and `inv_t` promoted by
    `swap()`); only maps whose explicit cap dropped it take the scatter,
    which is collision-free because kernel mapping is 1:1 per offset.
    """
    if maps.inv is not None and maps.inv.shape[1] == out_cap:
        return maps.inv
    k, cap = maps.in_idx.shape
    inv = torch.full((k, out_cap), -1, dtype=torch.int32,
                     device=maps.in_idx.device)
    ok = maps.valid & (maps.out_idx >= 0) & (maps.out_idx < out_cap)
    rows = torch.arange(k, device=inv.device)[:, None].expand(k, cap)
    inv[rows[ok], maps.out_idx[ok].long()] = maps.in_idx[ok].to(torch.int32)
    return inv


def window_schedule(inv: torch.Tensor, n_rows: int, out_tile: int,
                    feat_tile: int):
    """Per-out-tile feature-window schedule (the reference's streamed
    kernel plan; its integers are equal to the reference's).

    For each out tile: the range of feature row blocks its inverse-table
    slice touches.  wmap[o, w] = block id of sweep step w (clamped past the
    end so revisits cost nothing); nwin[o] = number of live steps.  With
    features in packed-key order the inverse tables are monotone per offset
    and these ranges are tight: the paper's cache blocks.
    """
    k, m = inv.shape
    tiles = m // out_tile
    n_win = n_rows // feat_tile
    iv = inv.reshape(k, tiles, out_tile)
    valid = iv >= 0
    mins = torch.where(valid, iv, n_rows).amin(dim=(0, 2))
    maxs = torch.where(valid, iv, -1).amax(dim=(0, 2))
    has = maxs >= 0
    wlo = torch.where(has, mins // feat_tile, 0).to(torch.int32)
    whi = torch.where(has, maxs // feat_tile, 0).to(torch.int32)
    nwin = torch.where(has, whi - wlo + 1, 0).to(torch.int32)
    sweep = torch.arange(n_win, dtype=torch.int32, device=inv.device)
    wmap = torch.minimum((wlo[:, None] + sweep[None, :]).clamp_min(0),
                         whi[:, None])
    return wmap, nwin


def sparse_conv_fod(features: torch.Tensor, maps: KernelMaps,
                    weights: torch.Tensor, out_cap: int) -> torch.Tensor:
    """The `flow="cuda"` conv: (N, Cin) features -> (out_cap, Cout)."""
    return spconv_fod_cuda(features.contiguous(), invert_maps(maps, out_cap),
                           weights.contiguous())


def sparse_conv_fused(features: torch.Tensor, maps: KernelMaps,
                      weights: torch.Tensor, out_cap: int,
                      epilogue: Epilogue | None = None) -> torch.Tensor:
    """The `flow="cuda_fused"` conv: `epilogue` runs in the kernel's flush."""
    epi = epilogue or Epilogue()

    def f32(t):
        return None if t is None else t.to(torch.float32).contiguous()

    epi = epi._replace(bias=f32(epi.bias), ln_scale=f32(epi.ln_scale),
                       ln_bias=f32(epi.ln_bias), mask=f32(epi.mask),
                       residual=f32(epi.residual))
    return spconv_fod_fused_cuda(features.contiguous(),
                                 invert_maps(maps, out_cap),
                                 weights.contiguous(), epi)
