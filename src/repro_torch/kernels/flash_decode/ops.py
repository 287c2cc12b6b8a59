"""The LM decode step's attention entry point: `flash_decode`.

Unlike the reference's wrapper this pads nothing: the CUDA kernel splits
each sequence's valid prefix over the CTAs of one cluster and reads no slot
at or past its length.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.flash_decode import flash_decode_cuda


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *, softcap: float | None = None,
                 scale: float | None = None) -> torch.Tensor:
    """Decode attention: q (B, Hq, hd) vs cache k/v (B, S, Hkv, hd) with
    per-sequence valid lengths (B,) -> (B, Hq, hd)."""
    return flash_decode_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                             lengths.to(torch.int32).contiguous(),
                             softcap=softcap, scale=scale)
