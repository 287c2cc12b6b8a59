"""Plain PyTorch version of the fused MLP kernel.

The kernel wrapper takes it for CPU tensors; the tests and `chip_smoke.py`
hold the kernel against it on the card; `nn.mlp_chain` is it on a
parameter dict.
"""

from __future__ import annotations

from typing import Sequence

import torch

CHUNK = 32   # K of one fresh fragment in the tensor-core kernel (kChunk)


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


def fused_mlp_tf32x3_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], final_act: bool = True,
                         products: int | None = None) -> torch.Tensor:
    """The tensor-core kernel's arithmetic (csrc/fused_mlp_tc.cu) in plain
    torch.  Per layer, h (float32) and W are split into hi = tf32(v) and
    lo = tf32(v - hi), rounded as `cvt.rna` rounds; each K chunk of CHUNK
    takes `products` products into a fresh sum that is added to the
    accumulator in float32: 3 (float32) lo_h hi_W + hi_h lo_W + hi_h hi_W;
    2 (bf16, the default for a bf16 x: W is exact in TF32, and so is x at
    layer 0) lo_h W + hi_h W; 1, hi_h hi_W, the one-product scheme the
    kernel does not use.  Then bias and ReLU (none on the last layer
    unless `final_act`); the result in x's dtype."""
    # imported here: spconv.ref -> core.sparseconv -> nn imports this module
    from repro_torch.kernels.spconv.ref import tf32_rna
    if products is None:
        products = 2 if x.dtype == torch.bfloat16 else 3
    if products not in (1, 2, 3):
        raise ValueError(f"products must be 1, 2 or 3, got {products}")
    h = x.to(torch.float32)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        w = w.to(torch.float32)
        h_hi, w_hi = tf32_rna(h), tf32_rna(w)
        h_lo, w_lo = tf32_rna(h - h_hi), tf32_rna(w - w_hi)
        terms = {1: [(h_hi, w_hi)], 2: [(h_lo, w_hi), (h_hi, w_hi)],
                 3: [(h_lo, w_hi), (h_hi, w_lo), (h_hi, w_hi)]}[products]
        acc = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float32,
                          device=h.device)
        for c0 in range(0, w.shape[0], CHUNK):
            part = torch.zeros_like(acc)
            for a, m in terms:
                part += a[:, c0:c0 + CHUNK] @ m[c0:c0 + CHUNK]
            acc += part
        h = acc + b.to(torch.float32)
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
