"""Plain PyTorch version of the flash attention kernel (the reference's
`attention_ref`): the wrapper takes it for CPU tensors, and the tests and
`chip_smoke.py` hold the kernel against it on the card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with GQA broadcast ->
    (B, Hq, Sq, D) in q's dtype.  float32 math; masked logits are -1e30."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qg = q.reshape(b, hkv, g, sq, d).to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)

    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(b, hq, sq, d).to(q.dtype)
