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
