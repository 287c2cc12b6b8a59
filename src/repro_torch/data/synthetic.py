"""Deterministic synthetic data (numpy only): token streams, LiDAR scenes
and point clouds.

The same functions, with the same seeds, as the reference package's
`data/synthetic.py`, so both packages see identical inputs.  Each is a
pure function of (seed, step, host): any host can regenerate any batch.
"""

from __future__ import annotations

import numpy as np


def token_batch(seed: int, step: int, batch: int, seq: int,
                vocab: int, host: int = 0, n_hosts: int = 1) -> dict:
    """Markov-ish synthetic token stream (not uniform noise: the LM has
    structure to learn, so train losses decrease).  int32 numpy arrays
    tokens / labels (the next token) / positions, each (batch // n_hosts,
    seq)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host]))
    b_loc = batch // n_hosts
    base = rng.integers(0, vocab, size=(b_loc, 1))
    steps = rng.integers(1, 17, size=(b_loc, seq + 1))
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    positions = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                (b_loc, seq)).copy()
    return {"tokens": tokens, "labels": labels, "positions": positions}


def lidar_scene(seed: int, n_points: int, grid: int = 64,
                n_objects: int = 8, batch_idx: int = 0):
    """Sparse voxelised scene: ground plane + box-like objects.
    Returns (coords (N, 4) int32 with batch col, mask (N,), feats (N, 4))."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, batch_idx]))
    pts = []
    n_ground = n_points // 3
    g = np.stack([rng.integers(0, grid, n_ground),
                  rng.integers(0, grid, n_ground),
                  np.zeros(n_ground, np.int64)], axis=1)
    pts.append(g)
    remaining = n_points - n_ground
    per = max(1, remaining // n_objects)
    for _ in range(n_objects):
        c = rng.integers(4, grid - 4, size=3)
        size = rng.integers(2, 6, size=3)
        p = c + rng.integers(-size, size + 1, size=(per, 3))
        pts.append(np.clip(p, 0, grid - 1))
    pts = np.concatenate(pts, axis=0)[:n_points]

    uniq = np.unique(pts, axis=0)
    n = uniq.shape[0]
    coords = np.full((n_points, 4), 2**30 - 1, np.int32)
    coords[:n, 0] = batch_idx
    coords[:n, 1:] = uniq
    mask = np.zeros(n_points, bool)
    mask[:n] = True
    feats = np.zeros((n_points, 4), np.float32)
    feats[:n, :3] = uniq / grid - 0.5
    feats[:n, 3] = rng.random(n)          # intensity channel
    return coords, mask, feats


def city_scene(seed: int, n_points: int, extent: int | None = None,
               batch_idx: int = 0):
    """City-block scale LiDAR mock: a large-extent ground sheet plus towers,
    with roughly `n_points` unique voxels (>= ~0.95 N for the default
    extent).  Same (coords, mask, feats) layout as `lidar_scene`."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, batch_idx]))
    if extent is None:
        extent = int(np.ceil(np.sqrt(n_points * 2.5)))
    m_ground = int(n_points * 1.1)
    ground = np.stack([rng.integers(0, extent, m_ground),
                       rng.integers(0, extent, m_ground),
                       rng.integers(0, 2, m_ground)], axis=1)
    towers = []
    n_towers = max(4, n_points // 4000)
    per = max(16, n_points // (4 * n_towers))
    for _ in range(n_towers):
        c = rng.integers(8, max(9, extent - 8), size=2)
        w = rng.integers(3, 9)
        h = rng.integers(6, 30)
        t = np.stack([c[0] + rng.integers(0, w, per),
                      c[1] + rng.integers(0, w, per),
                      rng.integers(0, h, per)], axis=1)
        towers.append(t)
    pts = np.concatenate([ground, *towers], axis=0)
    uniq = np.unique(np.clip(pts, 0, extent - 1), axis=0)
    uniq = uniq[rng.permutation(uniq.shape[0])[:n_points]]
    n = uniq.shape[0]
    coords = np.full((n_points, 4), 2**30 - 1, np.int32)
    coords[:n, 0] = batch_idx
    coords[:n, 1:] = uniq
    mask = np.zeros(n_points, bool)
    mask[:n] = True
    feats = np.zeros((n_points, 4), np.float32)
    feats[:n, :3] = uniq / extent - 0.5
    feats[:n, 3] = rng.random(n)
    return coords, mask, feats


def point_cloud_batch(seed: int, step: int, batch: int, n_points: int,
                      grid: int = 64):
    """Batched scenes flattened into one masked cloud + per-point labels
    (synthetic semantic task: ground vs object by height).  Returns
    (coords (B*N, 4), mask, feats (B*N, 4), labels (B*N,) int32)."""
    cs, ms, fs = [], [], []
    for b in range(batch):
        c, m, f = lidar_scene(seed + step * 1000, n_points, grid,
                              batch_idx=b)
        cs.append(c)
        ms.append(m)
        fs.append(f)
    coords = np.concatenate(cs, axis=0)
    mask = np.concatenate(ms, axis=0)
    feats = np.concatenate(fs, axis=0)
    labels = (coords[:, 3] > 0).astype(np.int32)     # object if z > 0
    labels[~mask] = 0
    return coords, mask, feats, labels


def dense_xyz_batch(seed: int, step: int, batch: int, n_points: int):
    """(B, N, 3) float clouds + masks + class labels for PointNet-family."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    labels = rng.integers(0, 8, size=batch).astype(np.int32)
    xyz = np.zeros((batch, n_points, 3), np.float32)
    for b in range(batch):
        # class-dependent ellipsoid
        ax = 0.3 + 0.1 * (labels[b] % 4)
        raw = rng.normal(size=(n_points, 3)).astype(np.float32)
        raw /= np.linalg.norm(raw, axis=1, keepdims=True) + 1e-6
        r = rng.random((n_points, 1)).astype(np.float32) ** (1 / 3)
        xyz[b] = raw * r * np.array([ax, 0.4, 1.0 - ax], np.float32)
    mask = np.ones((batch, n_points), bool)
    return xyz, mask, labels
