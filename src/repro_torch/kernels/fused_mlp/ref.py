"""Plain PyTorch version of the fused MLP kernel.

The kernel wrapper takes it for CPU tensors; the tests and `chip_smoke.py`
hold the kernel against it on the card; `nn.mlp_chain` is it on a
parameter dict.
"""

from __future__ import annotations

from typing import Sequence

import torch


def fused_mlp_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  final_act: bool = True) -> torch.Tensor:
    """h <- relu(h @ w + b) per layer (no ReLU on the last unless
    `final_act`), in float32; the result in x's dtype."""
    h = x.to(torch.float32)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w.to(torch.float32) + b.to(torch.float32)
        if i < n - 1 or final_act:
            h = torch.relu(h)
    return h.to(x.dtype)


def chain_operands(params: dict):
    """The weights and biases of an `nn.mlp_chain` parameter dict
    {"fc0": {"w", "b"}, ...} as two lists; a layer without "b" gets
    zeros."""
    ws = [params[f"fc{i}"]["w"] for i in range(len(params))]
    bs = [params[f"fc{i}"].get("b") for i in range(len(params))]
    bs = [torch.zeros(w.shape[1], dtype=w.dtype, device=w.device)
          if b is None else b for w, b in zip(ws, bs)]
    return ws, bs
