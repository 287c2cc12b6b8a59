"""Plain PyTorch versions of the fetch-on-demand sparse conv kernels.

The kernel wrappers take these for CPU tensors; the tests and
`chip_smoke.py` hold the kernels against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparseconv import Epilogue, apply_epilogue


def spconv_fod_ref(features: torch.Tensor, inv: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """out[j] = sum_k valid[k,j] * features[inv[k,j]] @ W[k]."""
    valid = inv >= 0                                          # (K, M)
    rows = features[inv.clamp(min=0).long()] * valid[..., None]
    out = torch.einsum("kmc,kcd->md", rows, weights)
    return out.to(features.dtype)


def spconv_fod_fused_ref(features: torch.Tensor, inv: torch.Tensor,
                         weights: torch.Tensor,
                         epilogue: Epilogue | None = None) -> torch.Tensor:
    """The conv + the shared plain epilogue: what the fused kernel's
    in-flush epilogue must reproduce."""
    return apply_epilogue(spconv_fod_ref(features, inv, weights), epilogue)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as `cvt.rna.tf32.f32` rounds; returned as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def spconv_fod_tf32x3_ref(features: torch.Tensor, inv: torch.Tensor,
                          weights: torch.Tensor, n_split: int = 1,
                          products: int = 3) -> torch.Tensor:
    """The tensor-core kernel's arithmetic (csrc/spconv_tc.cu) in plain
    torch: each operand split into hi = tf32(x) and lo = tf32(x - hi), each
    float32 product taken as lo*hi + hi*lo + hi*hi (`products=1`: hi*hi
    alone, the one-product scheme the kernel does not use), offsets
    k = r, r + n_split, ... summed into rank r's partial, and the partials
    summed in rank order."""
    if products not in (1, 3):
        raise ValueError(f"products must be 1 or 3, got {products}")
    valid = inv >= 0
    rows = features[inv.clamp(min=0).long()] * valid[..., None]  # (K, M, Cin)
    a_hi = tf32_rna(rows)
    b_hi = tf32_rna(weights)
    terms = [(a_hi, b_hi)]
    if products == 3:
        a_lo, b_lo = tf32_rna(rows - a_hi), tf32_rna(weights - b_hi)
        terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    k, m = inv.shape
    out = torch.zeros((m, weights.shape[2]), dtype=torch.float32,
                      device=features.device)
    for r in range(n_split):
        part = torch.zeros_like(out)
        for kk in range(r, k, n_split):
            for a, b in terms:
                part += a[kk] @ b[kk]
        out += part
    return out


def spconv_fod_fused_tf32x3_ref(features: torch.Tensor, inv: torch.Tensor,
                                weights: torch.Tensor,
                                epilogue: Epilogue | None = None,
                                n_split: int = 1) -> torch.Tensor:
    """`spconv_fod_tf32x3_ref` + the shared plain epilogue."""
    return apply_epilogue(
        spconv_fod_tf32x3_ref(features, inv, weights, n_split), epilogue)
