"""Plain PyTorch version of the flash-decode kernel (the reference's
`flash_decode_ref`, with the kernels' answer for an empty sequence)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k, v, lengths, *, softcap=None, scale=None):
    """q (B, Hq, hd); k/v (B, S, Hkv, hd); lengths (B,) -> (B, Hq, hd) in
    q's dtype.  Slots at or past `lengths[b]` are masked to -1e30.  A
    sequence of length 0 gets zeros, as the CUDA kernel and the reference's
    Pallas kernel write (the reference's oracle, whose softmax then runs
    over -1e30 alone, averages every slot there instead)."""
    b, hq, hd = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, hkv, g, hd).to(torch.float32) * scale
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, hq, hd).to(q.dtype)
