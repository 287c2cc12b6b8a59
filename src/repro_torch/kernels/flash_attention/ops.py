"""The LM's attention entry point: `flash_attention`, with a backward.

As the reference's `ops.flash_attention` (a custom VJP), the forward runs
the hand-written kernel (`flash_attention_cuda`: wgmma for bf16, FMAs
otherwise) and the backward recomputes the attention through the plain
version (`ref.attention_ref`) and differentiates that, so the kernel needs
no backward of its own; a hand-written backward kernel is speed-up work
(ROADMAP Queue B).  Nothing is padded: both CUDA kernels mask any Sq and
Skv.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return flash_attention_cuda(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(w)
                   for t, w in zip(ctx.saved_tensors, wanted)]
            out = attention_ref(*qkv, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t in qkv if t.requires_grad], g))
        return (*(next(grads) if w else None for w in wanted),
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window, softcap,
                                 scale)
