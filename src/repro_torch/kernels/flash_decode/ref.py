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


def flash_decode_split_ref(q, k, v, lengths, n_split: int, *, softcap=None,
                           scale=None):
    """The CUDA kernel's split, in plain PyTorch (for tests): each sequence's
    valid prefix len_b = clamp(lengths[b], 0, S) cut into n_split chunks
    [i c, min(len_b, (i + 1) c)), c = ceil(len_b / n_split) rounded up to
    the positions one warp's load covers (32 / the lanes a row of the
    kernel's launch plan for these operands); each chunk's softmax
    statistics (m, l, acc), -1e30 / 0 / 0 where it is empty, merged by
    log-sum-exp, and l == 0 -> 1 at the end (zeros where every chunk is
    empty)."""
    from repro_torch.kernels.flash_decode.flash_decode import plan_launch
    align = 32 // plan_launch(q, k, v, n_sm=0, n_split=n_split).gs
    b, hq, hd = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, hkv, g, hd).to(torch.float32) * scale
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    length = lengths.long().clamp(0, s)
    c = (length + n_split - 1) // n_split
    c = (c + align - 1) // align * align                      # (B,)
    pos = torch.arange(s, device=q.device)
    chunk = torch.arange(n_split, device=q.device)
    start = chunk[None, :] * c[:, None]                         # (B, n)
    member = (pos[None, None, :] >= start[:, :, None]) \
        & (pos[None, None, :] < (start + c[:, None])[:, :, None]) \
        & (pos[None, None, :] < length[:, None, None])          # (B, n, S)
    member = member[:, None, None]                              # (B,1,1,n,S)
    lc = torch.where(member, logits[:, :, :, None, :], NEG_INF)
    m = lc.max(dim=-1).values                                   # (B,H,G,n)
    p = torch.where(member, torch.exp(lc - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgns,bshd->bhgnd", p, v.to(torch.float32))
    w = torch.exp(m - m.max(dim=-1, keepdim=True).values)
    l = (w * l).sum(-1)
    acc = (w[..., None] * acc).sum(-2)
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, hd).to(q.dtype)
