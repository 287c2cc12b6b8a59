"""Losses — the port of the reference's `train/losses.py`.

`chunked_cross_entropy` never holds the full (B, S, V) logits: the head
product and logsumexp run per sequence chunk, each chunk under
`torch.utils.checkpoint` (the reference `jax.checkpoint`s it), so the
backward recomputes a chunk's logits instead of keeping them live.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _mask(labels: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return torch.ones_like(labels, dtype=torch.float32)
    return mask.to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """logits (B, S, V), labels (B, S) -> (mean loss, n_tokens), both
    float32 scalars; log-softmax in float32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = lp.gather(-1, labels.long()[..., None])[..., 0]
    mask = _mask(labels, mask)
    n = mask.sum().clamp(min=1.0)
    return -(ll * mask).sum() / n, n


def chunked_cross_entropy(hidden: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          softcap: Optional[float] = None,
                          n_chunks: int = 16, transpose_head: bool = False):
    """hidden (B, S, D); head_w (D, V) (or (V, D) with transpose_head, for
    tied embeddings); labels (B, S) -> (mean loss, n_tokens).  S not a
    multiple of n_chunks falls back to one chunk."""
    b, s, d = hidden.shape
    if s % n_chunks != 0:
        n_chunks = 1
    c = s // n_chunks
    mask = _mask(labels, mask)
    labels = labels.long()
    w = head_w.T if transpose_head else head_w

    def chunk_loss(h, lbl, m):
        logits = torch.einsum("bcd,dv->bcv", h, w).to(torch.float32)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, lbl[..., None])[..., 0]
        return ((lse - picked) * m).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(chunk_loss, hidden[:, sl], labels[:, sl],
                                   mask[:, sl], use_reentrant=False)
    n = mask.sum().clamp(min=1.0)
    return total / n, n


def zloss(logits: torch.Tensor, weight: float = 1e-4) -> torch.Tensor:
    """Router / logit z-loss regulariser: weight * mean(logsumexp^2)."""
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    return weight * (lse ** 2).mean()
