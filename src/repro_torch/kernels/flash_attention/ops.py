"""The LM's attention entry point: `flash_attention`, with a backward.

As the reference's `ops.flash_attention` (a custom VJP), the forward runs
the hand-written kernel (`flash_attention_cuda`: wgmma for bf16, FMAs
otherwise) and the backward recomputes the attention through the plain
version (`ref.attention_ref`) and differentiates that, so the kernel needs
no backward of its own; a hand-written backward kernel is speed-up work
(ROADMAP Queue B).  The recompute holds (Sq, Skv) float32 scores for
every query head it takes at once, so it takes rows and kv heads in
chunks of at most SCORE_BUDGET scores (qwen2-vl-72b's train step at 16
sequences of 4096 a rank would hold 69 GB of them a tensor); each chunk's
gradients are those of its own rows and heads.  Nothing is padded: both
CUDA kernels mask any Sq and Skv.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


SCORE_BUDGET = 2 ** 30     # float32 scores a backward chunk holds (4 GiB)


def _chunks(b: int, hkv: int, scores_a_head: int):
    """(row slice, kv-head slice) pairs covering (b, hkv), each holding at
    most SCORE_BUDGET scores (a single kv head and row may hold more)."""
    heads = max(1, min(hkv, SCORE_BUDGET // scores_a_head))
    rows = max(1, SCORE_BUDGET // (scores_a_head * hkv)) if heads == hkv \
        else 1
    return [(slice(i, i + rows), slice(j, j + heads))
            for i in range(0, b, rows) for j in range(0, hkv, heads)]


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
        q, k, v = ctx.saved_tensors
        b, hq, sq, _ = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        group = hq // hkv
        chunks = _chunks(b, hkv, group * sq * skv)
        parts = [[] for _ in wanted]
        for rows, heads in chunks:
            qh = slice(heads.start * group, heads.stop * group)
            if len(chunks) == 1:
                pieces = (q, k, v, g)
            else:
                pieces = (q[rows, qh], k[rows, heads], v[rows, heads],
                          g[rows, qh])
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_(w)
                       for t, w in zip(pieces[:3], wanted)]
                out = attention_ref(*qkv, **ctx.kw)
                grads = iter(torch.autograd.grad(
                    out, [t for t in qkv if t.requires_grad], pieces[3]))
            for part, w in zip(parts, wanted):
                if w:
                    part.append(next(grads))
        if len(chunks) == 1:
            got = [part[0] if w else None for part, w in zip(parts, wanted)]
        else:
            got = [_assemble(part, chunks) if w else None
                   for part, w in zip(parts, wanted)]
        return (*got, None, None, None, None)


def _assemble(parts, chunks):
    """The chunks' gradients (rows x heads pieces, `_chunks` order) as
    one tensor: heads concatenated within a row chunk, then the rows."""
    per_row = {}
    for piece, (rows, _) in zip(parts, chunks):
        per_row.setdefault(rows.start, []).append(piece)
    return torch.cat([torch.cat(per_row[i], dim=1) for i in sorted(per_row)])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window, softcap,
                                 scale)
