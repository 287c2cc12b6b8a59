"""Exact halo computation: which input points does a chunk need so its
conv outputs match the monolithic network bit-for-bit on interior points?
(On the card, up to the order of float32 sums: see `plan`.)

Sparse convolution influence only flows through PRESENT sites: a
submanifold conv at level l gathers the (at most 27) present neighbours
of each site, a stride-2 down conv gathers the (at most 8) present fine
sites of each coarse cell, and the transposed decoder conv gathers
exactly the cell a fine site lives in.  The needed-input set of a chunk's
interior is therefore computable EXACTLY — no conservative bounding box —
by walking the network's conv sites backward over the full cloud's stride
pyramid and propagating "needed" marks along those present-site edges:

    marks[level 0] = chunk interior
    decoder (reversed):  dilate by that stage's submanifold stencil,
                         then lift marks fine -> coarse (cell members);
    encoder (reversed):  dilate at each level (skip-join marks included —
                         the decoder concatenates the encoder output, so
                         its needs flow into the encoder backward pass),
                         then drop marks coarse -> fine (cell lookup);
    stem:                one final dilation at level 0.

Every edge lookup is a binary search of shifted/quantized packed keys
against a level's sorted keys — the `kernel_map_v2` machinery, run
host-side (numpy searchsorted over the composed uint64 keys) because
chunk populations are dynamic shapes.  Marks for ALL chunks propagate in
one pass as an (n_sites, n_chunks) boolean matrix: the neighbour tables
are chunk-independent, so the fan-out costs gathers + ORs, not repeated
searches.

Exactness argument (the headline invariant): by induction over the
backward walk, every site marked needed at a level has (a) its full fine
support marked at the level below, so the chunk's own downsample
reconstructs the site with the monolithic feature, and (b) every present
neighbour its convs gather marked needed too, so no partially-supported
border cell ever contributes to an interior output.  Chunk clouds are
subsets of the monolithic cloud, so no extra sites appear either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import packed as PK


class HaloSpec(NamedTuple):
    """Receptive-field description of a MinkUNet-style stride pyramid.

    `dec_rounds[l]` — submanifold dilation rounds the decoder runs at
    level l (two per residual block of the stage that PRODUCES level l);
    `enc_rounds[l]` — rounds the encoder runs at level l (the stem at
    level 0, two per block for levels 1..n_stages).
    """

    n_stages: int
    dec_rounds: tuple[int, ...]   # length n_stages     (levels 0..S-1)
    enc_rounds: tuple[int, ...]   # length n_stages + 1 (levels 0..S)

    @classmethod
    def uniform(cls, n_stages: int, blocks_per_stage: int) -> "HaloSpec":
        r = 2 * blocks_per_stage
        return cls(n_stages, (r,) * n_stages,
                   (1,) + (r,) * n_stages)


class KeyPyramid(NamedTuple):
    """The full cloud's stride pyramid as sorted unique uint64 key arrays
    (level l at stride 2**l), plus the map from level-0 unique sites back
    to unique-site ids of the ranking order."""

    levels: tuple[np.ndarray, ...]   # level l: ascending unique uint64 keys


def build_pyramid(keys0_unique: np.ndarray, n_stages: int) -> KeyPyramid:
    """Coarsen the (already unique, ascending, sentinel-free) level-0
    keys through `n_stages` stride doublings — quantization happens in
    the key domain (clear low bits per field), dedup is np.unique on the
    host: the partition-planner analogue of `mapping.downsample_sorted`.
    """
    levels = [np.asarray(keys0_unique, np.uint64)]
    for l in range(1, n_stages + 1):
        levels.append(np.unique(PK.quantize_key64(levels[-1], 2 ** l)))
    return KeyPyramid(tuple(levels))


def _lookup(level_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query key in a level's sorted keys, -1 on miss
    (including sentinel queries from out-of-budget shifts)."""
    idx = np.searchsorted(level_keys, queries)
    n = level_keys.shape[0]
    safe = np.clip(idx, 0, max(n - 1, 0))
    hit = (idx < n) & (queries != PK.KEY64_SENTINEL)
    if n:
        hit &= level_keys[safe] == queries
    return np.where(hit, safe, -1).astype(np.int64)


def subm_table(level_keys: np.ndarray, stride: int) -> np.ndarray:
    """(27, n) neighbour table for the k=3 submanifold stencil at
    `stride`: row k holds the level index of site + offset_k (-1 when
    absent).  Offsets go through unpack -> shift -> repack so border
    sites that would leave the coordinate budget saturate to a miss
    instead of aliasing another field."""
    coords = PK.unpack_key64(level_keys)
    tables = []
    for dx in (-stride, 0, stride):
        for dy in (-stride, 0, stride):
            for dz in (-stride, 0, stride):
                shifted = coords + np.array([0, dx, dy, dz], np.int32)
                tables.append(_lookup(level_keys,
                                      PK.pack_coords_host(shifted)))
    return np.stack(tables)


def up_table(fine_keys: np.ndarray, coarse_keys: np.ndarray,
             fine_stride: int) -> np.ndarray:
    """(8, n_coarse) table: fine-level indices of each coarse cell's
    members (the k=2 down-conv support; -1 where the fine site is
    absent).  Cell-member fields never overflow, so the shift happens
    directly in the key domain."""
    s = np.uint64(fine_stride)
    tables = []
    for dx in (np.uint64(0), s):
        for dy in (np.uint64(0), s):
            for dz in (np.uint64(0), s):
                q = coarse_keys + ((dx << np.uint64(32))
                                   | (dy << np.uint64(16)) | dz)
                tables.append(_lookup(fine_keys, q))
    return np.stack(tables)


def cell_table(fine_keys: np.ndarray, coarse_keys: np.ndarray,
               coarse_stride: int) -> np.ndarray:
    """(n_fine,) table: coarse-level index of each fine site's cell
    (always present — the cell was built from its members)."""
    return _lookup(coarse_keys, PK.quantize_key64(fine_keys, coarse_stride))


def _or_gather(src_marks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(n_src, C) marks gathered through a (K, n_dst) index table into
    (n_dst, C) marks: dst |= src[table[k]] over the K stencil rows."""
    n_dst = table.shape[1]
    out = np.zeros((n_dst, src_marks.shape[1]), bool)
    for k in range(table.shape[0]):
        idx = table[k]
        ok = idx >= 0
        out[ok] |= src_marks[idx[ok]]
    return out


def _dilate(marks: np.ndarray, table: np.ndarray, rounds: int) -> np.ndarray:
    for _ in range(rounds):
        marks = _or_gather(marks, table)
    return marks


def needed_marks(pyramid: KeyPyramid, spec: HaloSpec,
                 interior: np.ndarray) -> np.ndarray:
    """(n_level0_sites, n_chunks) needed-input marks from (same-shaped)
    interior marks: the backward walk described in the module docstring.
    The returned marks are a superset of the interior (influence includes
    the identity path), so `needed & ~interior` is exactly the halo."""
    S = spec.n_stages
    if len(pyramid.levels) != S + 1:
        raise ValueError(f"pyramid has {len(pyramid.levels)} levels, spec "
                         f"wants {S + 1}")
    subm = [subm_table(pyramid.levels[l], 2 ** l) for l in range(S + 1)]
    m = [None] * (S + 1)
    m[0] = np.asarray(interior, bool).copy()
    # decoder, reversed: level l marks dilate through the stage's blocks,
    # then lift onto the transposed conv's coarse input
    for l in range(S):
        m[l] = _dilate(m[l], subm[l], spec.dec_rounds[l])
        m[l + 1] = _or_gather(
            m[l], up_table(pyramid.levels[l], pyramid.levels[l + 1], 2 ** l))
    # encoder, reversed: skip-join marks are already in m[l]; dilate, then
    # drop every needed cell's full fine support onto the level below
    for l in range(S, 0, -1):
        m[l] = _dilate(m[l], subm[l], spec.enc_rounds[l])
        cells = cell_table(pyramid.levels[l - 1], pyramid.levels[l], 2 ** l)
        m[l - 1] |= m[l][cells]
    return _dilate(m[0], subm[0], spec.enc_rounds[0])
