"""Ranking-based neighbourhood ops for PointNet++-family networks.

Paper Table 1 / section 4.1: farthest point sampling -> Max over distances,
k-nearest-neighbours / ball query -> TopK over distances.  The reference
computes them in plain jnp; these are the same dataflows in torch ops, with
the same integer results:

  * distances keep `pairwise_sqdist`'s formula (a^2 + b^2 - 2ab, clamped at
    0), so near-ties round as in the reference;
  * TopK is a stable ascending sort: ties (every masked reference sits at
    exactly 1e10) come lowest index first, as `lax.top_k` returns them;
  * FPS keeps the running-min / first-argmax dataflow, batched over B, with
    no host synchronisation inside the sample loop.

Convention: dense-batched float clouds `xyz` (B, N, 3) with a validity mask
(B, N).  Invalid points are pushed to 1e10 distance so ranking ignores them.
"""

from __future__ import annotations

import torch

_INF = 1e10


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) squared euclidean distance."""
    a2 = (a * a).sum(-1, keepdim=True)                    # (..., M, 1)
    b2 = (b * b).sum(-1)[..., None, :]                    # (..., 1, N)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


# ---------------------------------------------------------------------------
# Farthest point sampling: iterative Max ranking (paper Fig. 8b)
# ---------------------------------------------------------------------------

def farthest_point_sampling(xyz: torch.Tensor, mask: torch.Tensor,
                            n_samples: int) -> torch.Tensor:
    """(B, N, 3), (B, N) -> (B, n_samples) int32 indices.

    Per cloud: start at the first valid point, keep a running
    min-distance-to-selected array (+1e10 valid, -1e10 invalid) and take
    its first argmax each step: the paper's FPS dataflow."""
    b = xyz.shape[0]
    last = mask.to(torch.uint8).argmax(dim=1)             # first valid point
    min_d = torch.where(mask, _INF, -_INF).to(xyz.dtype)
    sel = [last]
    for _ in range(1, n_samples):
        centre = xyz.gather(1, last.view(b, 1, 1).expand(b, 1, 3))
        diff = xyz - centre
        d = (diff * diff).sum(-1)
        d = torch.where(mask, d, -_INF)
        min_d = torch.minimum(min_d, d)
        last = min_d.argmax(dim=1)                        # Max ranking op
        sel.append(last)
    return torch.stack(sel, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# kNN / ball query: TopK ranking (paper Fig. 8c)
# ---------------------------------------------------------------------------

def knn(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
        rmask: torch.Tensor, k: int, chunk: int = 1024):
    """k nearest neighbours.  (B,M,3) queries, (B,N,3) refs ->
    idx (B,M,k) int32, sqdist (B,M,k).

    The M axis is taken `chunk` queries at a time so the (chunk, N)
    distance tile bounds memory.  With fewer refs than k, the last
    neighbour is repeated at 1e10 distance.  `qmask` is unused, as in the
    reference: every query gets neighbours.
    """
    b, m, _ = query.shape
    n_ref = ref.shape[1]
    k_eff = min(k, n_ref)
    idx_parts, dist_parts = [], []
    for s in range(0, max(m, 1), chunk):
        d = pairwise_sqdist(query[:, s:s + chunk], ref)    # (B, chunk, N)
        d = torch.where(rmask[:, None, :], d, _INF)
        dist, idx = torch.sort(d, dim=-1, stable=True)
        idx_parts.append(idx[..., :k_eff])
        dist_parts.append(dist[..., :k_eff])
    idx = torch.cat(idx_parts, dim=1)[:, :m]
    dist = torch.cat(dist_parts, dim=1)[:, :m]
    if k_eff < k:
        idx = torch.cat([idx] + [idx[..., -1:]] * (k - k_eff), dim=-1)
        dist = torch.cat([dist, dist.new_full((b, m, k - k_eff), _INF)],
                         dim=-1)
    return idx.to(torch.int32), dist


def ball_query(query: torch.Tensor, qmask: torch.Tensor, ref: torch.Tensor,
               rmask: torch.Tensor, radius: float, k: int,
               chunk: int = 1024):
    """Ball query = TopK further constrained to d <= r^2 (paper 2.1.2).

    Out-of-ball slots take the first neighbour (PointNet++ padding, so the
    group tensor stays dense).  Returns idx (B,M,k) and validity (B,M,k):
    a query with no neighbour in the ball keeps its nearest, marked
    invalid.
    """
    idx, dist = knn(query, qmask, ref, rmask, k, chunk=chunk)
    inside = dist <= radius * radius
    idx = torch.where(inside, idx, idx[..., :1])
    valid = inside | inside[..., :1]
    return idx, valid


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, ...) -> (B, ..., C) batched gather."""
    batch = torch.arange(points.shape[0], device=points.device)
    return points[batch.view(-1, *([1] * (idx.dim() - 1))), idx.long()]
