"""The LM's attention entry point: `flash_attention` (forward only).

The reference's `ops.flash_attention` wraps its Pallas kernel in a custom
VJP whose backward recomputes through `attention_ref`; the port serves and
does not train yet, so this is the forward alone (the backward is listed in
ROADMAP.md).  Nothing is padded: both CUDA kernels mask any Sq and Skv.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window, softcap=softcap,
                                scale=scale)
