"""Plain PyTorch versions of the flash attention kernels.

`attention_ref` is the reference's `attention_ref`: the wrapper takes it for
CPU tensors, and the tests and `chip_smoke.py` hold both kernels against it
on the card.  `attention_bf16p_ref` models the tensor-core kernel's
rounding (P rounded to bf16 before PV), so the CPU tests can bound that
rounding against the reference before the card sees it."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _logits(q, k, causal, window, softcap, scale):
    """Masked float32 logits (B, Hkv, G, Sq, Skv)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    qg = q.reshape(b, hkv, g, sq, d).to(torch.float32) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)

    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return torch.where(mask, s, NEG_INF)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) with GQA broadcast ->
    (B, Hq, Sq, D) in q's dtype.  float32 math; masked logits are -1e30."""
    p = torch.softmax(_logits(q, k, causal, window, softcap, scale), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(q.shape).to(q.dtype)


def attention_bf16p_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """`attention_ref` with the tensor-core kernel's roundings: logits in
    float32, weights p = exp(s - max) rounded to bf16 before p @ v (float32
    sums), l summed over the float32 weights, output in q's dtype."""
    s = _logits(q, k, causal, window, softcap, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(),
                      v.to(torch.float32))
    out = pv / p.sum(dim=-1, keepdim=True)
    return out.reshape(q.shape).to(q.dtype)
