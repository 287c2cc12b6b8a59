"""Fusion plan -> kernel calls.

  * `fused_mlp`       — one fusion group through the kernel.
  * `fused_mlp_chain` — an `nn.mlp_chain` parameter dict through the groups
    that `core.fusion.plan_fusion` chooses at the card's budget, one launch
    per group.

Unlike the TPU wrappers these pad nothing: the CUDA kernel masks the ragged
row tile and odd widths itself, and picks its own row tile.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.fusion import plan_fusion
from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp_cuda
from repro_torch.kernels.fused_mlp.ref import chain_operands


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor], *,
              final_act: bool = True) -> torch.Tensor:
    """x (N, C0) through one fused group -> (N, C_L) in x's dtype."""
    return fused_mlp_cuda(x.contiguous(), [w.contiguous() for w in weights],
                          [b.contiguous() for b in biases], final_act)


def fused_mlp_chain(x: torch.Tensor, params: dict, *,
                    final_act: bool = True) -> torch.Tensor:
    """Apply an `nn.mlp_chain` parameter dict to x (N, C0) through fusion
    groups chosen by the paper's compile-time planner at the card's
    budget."""
    ws, bs = chain_operands(params)
    groups = plan_fusion([ws[0].shape[0]] + [w.shape[1] for w in ws])
    h = x
    for gi, g in enumerate(groups):
        last_group = gi == len(groups) - 1
        h = fused_mlp(h, ws[g.start:g.start + g.n_layers],
                      bs[g.start:g.start + g.n_layers],
                      final_act=final_act or not last_group)
    return h
