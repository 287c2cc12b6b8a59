"""Ranking-based mapping (PointAcc Mapping Unit, paper §4.1): two engines.

  * v2 ("packed", the default for D = 3): every cloud is packed into int64
    keys (`core.packed`) and sorted ONCE into a `SortedCloud`; each kernel
    offset is then one vectorised binary search of the shifted output keys
    against the sorted input keys.  Because the search is indexed by output
    row, the hit table is the inverse table `inv[k, j] = input row feeding
    output j under offset k` (-1 = none) that the sparse-conv kernels
    consume, with no scatter pass.
  * v1 ("lex"): one stable lexicographic sort of both clouds per kernel
    offset, adjacent-equality detection, a compaction sort (paper Fig. 9).
    It works on the int32 coordinate columns themselves, so it takes any
    spatial dimensionality and any int32 coordinate or batch index (the
    packed keys hold coordinates in -32768..32767 and batch 0..16383).
    torch has no multi-column sort: `_lex_sort` runs stable single-column
    sorts from the last key to the first (LSD order), which gives the
    order of the reference's `lax.sort(num_keys=d, is_stable=True)`.  Its
    maps carry no inverse table; the kernel flows build one by scatter.

Point clouds are fixed-capacity tensors with validity masks; invalid rows
hold SENTINEL coordinates, which sort to the end and match nothing.
Inverse tables are int32, as in the reference and as the kernels take
them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import packed as PK

SENTINEL = PK.COORD_SENTINEL

DEFAULT_ENGINE = "v2"


class PointCloud(NamedTuple):
    """A fixed-capacity, masked, sparse voxel point cloud."""

    coords: torch.Tensor  # (N, 1+D) int32; invalid rows = SENTINEL
    mask: torch.Tensor    # (N,) bool
    stride: int           # tensor stride (power of two)

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim_spatial(self) -> int:
        return self.coords.shape[1] - 1

    def num_valid(self) -> torch.Tensor:
        return self.mask.sum()


class KernelMaps(NamedTuple):
    """Input/output maps for one sparse convolution.

    Row k lists the matched (input index, output index) pairs of offset k,
    padded with -1 / valid=False.  `inv` (K, out_cap) is the inverse table
    inv[k, j] = input row feeding output j (-1 = none); `inv_t` (K, in_cap)
    the same table for the swapped maps (decoder transposed convs).
    """

    in_idx: torch.Tensor   # (K, cap) int32, -1 padded
    out_idx: torch.Tensor  # (K, cap) int32, -1 padded
    valid: torch.Tensor    # (K, cap) bool
    offsets: np.ndarray    # (K, D) static offsets (units of input stride)
    inv: torch.Tensor | None = None
    inv_t: torch.Tensor | None = None

    def swap(self, require_inverse: bool = False) -> "KernelMaps":
        """Transpose the maps for a transposed (up-sampling) conv; the
        inverse tables swap roles with them.  Maps built by the v1 engine,
        or whose explicit `cap` dropped the tables, carry no transposed
        inverse table; pass `require_inverse=True` to make that a loud
        error."""
        if require_inverse and self.inv_t is None:
            raise ValueError(
                "swapped maps carry no inverse table (inv_t is None): the "
                "maps were built by the v1 engine or with an explicit cap "
                "that dropped them.  The kernel flows would fall back to a "
                "scatter-built inverse; rebuild the maps with engine='v2' "
                "and the default cap for the scatter-free transposed path")
        return KernelMaps(self.out_idx, self.in_idx, self.valid,
                          -self.offsets, inv=self.inv_t, inv_t=self.inv)


def make_point_cloud(coords: torch.Tensor, mask: torch.Tensor,
                     stride: int = 1) -> PointCloud:
    """Normalise a raw (coords, mask) pair: sentinel-fill invalid rows."""
    coords = coords.to(torch.int32)
    coords = torch.where(mask[:, None], coords,
                         torch.full_like(coords, SENTINEL))
    return PointCloud(coords, mask, stride)


def kernel_offsets(kernel_size: int, ndim: int, stride: int) -> np.ndarray:
    """All kernel offsets delta in {-(k//2)..k//2}^D (0..k-1 for even k),
    scaled by the input tensor stride.  Static numpy: offsets index the
    weight tensor."""
    half = kernel_size // 2
    rng = np.arange(-half, half + 1) if kernel_size % 2 == 1 else \
        np.arange(0, kernel_size)
    grids = np.meshgrid(*([rng] * ndim), indexing="ij")
    offs = np.stack([g.reshape(-1) for g in grids], axis=1)
    return (offs * stride).astype(np.int32)


# ---------------------------------------------------------------------------
# v1 engine: lexicographic sorts of the coordinate columns
# ---------------------------------------------------------------------------

def quantize_coords(coords: torch.Tensor, stride: int) -> torch.Tensor:
    """q = floor(p / ts) * ts for ts a power of two, batch column kept:
    an arithmetic shift right then left, which floors negative
    coordinates too (int32 two's complement, as in the reference)."""
    if stride == 1:
        return coords
    k = int(np.log2(stride))
    if 2 ** k != stride:
        raise ValueError(f"stride must be a power of two, got {stride}")
    spatial = (coords[:, 1:] >> k) << k
    return torch.cat([coords[:, :1], spatial], dim=1)


def _lex_sort(columns, num_keys: int):
    """Stable lexicographic sort of parallel tensors along their last axis
    on the first `num_keys` columns: one stable single-column sort per key,
    last key first, each refining the order of the passes before it.  The
    other columns ride along.  Leading axes are batch axes (one sort a
    row)."""
    perm = torch.arange(columns[0].shape[-1], device=columns[0].device)
    perm = perm.expand(columns[0].shape).contiguous()
    for col in reversed(columns[:num_keys]):
        _, order = torch.sort(col.gather(-1, perm), dim=-1, stable=True)
        perm = perm.gather(-1, order)
    return tuple(c.gather(-1, perm) for c in columns)


def _sentinel_fill(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], coords,
                       torch.full_like(coords, SENTINEL))


def unique_coords(coords: torch.Tensor, mask: torch.Tensor):
    """Deduplicate a masked coordinate set without dynamic shapes: sort
    lexicographically, keep first occurrences, overwrite duplicates with
    SENTINEL and sort again to compact the valid rows to the front.
    Returns (coords (N, d), mask (N,))."""
    d = coords.shape[1]
    coords = _sentinel_fill(coords, mask)
    srt = torch.stack(_lex_sort(tuple(coords.T), num_keys=d), dim=1)
    is_first = torch.ones(srt.shape[0], dtype=torch.bool,
                          device=srt.device)
    is_first[1:] = (srt[1:] != srt[:-1]).any(dim=1)
    new_mask = is_first & (srt != SENTINEL).all(dim=1)
    deduped = _sentinel_fill(srt, new_mask)
    compact = torch.stack(_lex_sort(tuple(deduped.T), num_keys=d), dim=1)
    return compact, (compact != SENTINEL).all(dim=1)


def downsample(pc: PointCloud, factor: int = 2) -> PointCloud:
    """Output cloud of a strided conv: quantize to the coarser stride, then
    deduplicate (both ranking-based)."""
    new_stride = pc.stride * factor
    q = _sentinel_fill(quantize_coords(pc.coords, new_stride), pc.mask)
    coords, mask = unique_coords(q, pc.mask)
    return PointCloud(coords, mask, new_stride)


def _intersect_one_offset(shifted: torch.Tensor, in_mask: torch.Tensor,
                          out_coords: torch.Tensor, out_mask: torch.Tensor,
                          cap: int):
    """Coordinate-equal pairs between shifted input clouds and the output
    cloud (paper Fig. 9), for a batch of offsets at once: `shifted` is
    (K, n, d), one shifted copy of the input a row.

    Both clouds are coordinate sets, so each match is 1:1.  One
    lexicographic sort of the merged clouds on (coords, tag) puts the
    input element (tag 0) of a matching pair right before its output
    element (tag 1); a stable sort on "not a pair" then compacts the
    matches to the front in coordinate order, the reference's slot for
    each.  Returns (in_idx, out_idx, valid), each (K, min(cap, n + m))."""
    kk, n, d = shifted.shape
    m = out_coords.shape[0]
    dev = shifted.device
    shifted = _sentinel_fill(shifted, in_mask)
    out_c = _sentinel_fill(out_coords, out_mask)
    merged = torch.cat([shifted, out_c.expand(kk, m, d)], dim=1)
    tag = torch.cat([torch.zeros(n, dtype=torch.int32, device=dev),
                     torch.ones(m, dtype=torch.int32, device=dev)])
    payload = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                         torch.arange(m, dtype=torch.int32, device=dev)])
    valid = torch.cat([in_mask, out_mask])
    cols = tuple(merged[..., i] for i in range(d)) + tuple(
        c.expand(kk, n + m) for c in (tag, payload, valid))
    *s_cols, s_tag, s_payload, s_valid = _lex_sort(cols, num_keys=d + 1)
    s_coords = torch.stack(s_cols, dim=-1)

    is_pair = torch.zeros_like(s_valid)
    is_pair[:, :-1] = ((s_coords[:, :-1] == s_coords[:, 1:]).all(dim=-1)
                       & (s_tag[:, :-1] == 0) & (s_tag[:, 1:] == 1)
                       & s_valid[:, :-1] & s_valid[:, 1:])
    nxt_payload = torch.roll(s_payload, -1, dims=1)
    in_i = torch.where(is_pair, s_payload, -1)
    out_i = torch.where(is_pair, nxt_payload, -1)
    _, in_i, out_i, is_pair = _lex_sort(
        ((~is_pair).to(torch.int32), in_i, out_i, is_pair), num_keys=1)
    return in_i[:, :cap], out_i[:, :cap], is_pair[:, :cap]


def kernel_map(in_pc: PointCloud, out_pc: PointCloud, kernel_size: int,
               cap: int | None = None) -> KernelMaps:
    """v1 kernel maps: for each weight offset delta, the (-delta)-shifted
    input cloud intersected with the output cloud, all offsets in one
    batched pass (the reference vmaps the same work).  Coordinates stay
    int32: `coords - delta` wraps as the reference's does."""
    offs = kernel_offsets(kernel_size, in_pc.ndim_spatial, in_pc.stride)
    cap = cap if cap is not None else min(in_pc.capacity, out_pc.capacity)
    offs_full = np.concatenate(
        [np.zeros((offs.shape[0], 1), np.int32), offs], axis=1)
    off_t = torch.as_tensor(offs_full, device=in_pc.coords.device)
    shifted = in_pc.coords[None] - off_t[:, None, :]
    in_idx, out_idx, valid = _intersect_one_offset(
        shifted, in_pc.mask, out_pc.coords, out_pc.mask, cap)
    return KernelMaps(in_idx, out_idx, valid, offs)


class SortedCloud(NamedTuple):
    """A point cloud plus its once-computed ranking structure:
    `sorted_keys` ascending (sentinels last), `perm` maps sorted position
    -> original row (sorted_keys = keys[perm])."""

    pc: PointCloud
    sorted_keys: torch.Tensor  # (N,) int64
    perm: torch.Tensor         # (N,) int64


def sort_cloud(pc: PointCloud) -> SortedCloud:
    """Rank a cloud once: pack coords to keys and stable-sort them.
    Raises on valid points outside the packed-key budget instead of
    silently dropping them from every map."""
    if pc.ndim_spatial != 3:
        raise ValueError("packed-key engine requires 3 spatial dims, got "
                         f"{pc.ndim_spatial}; use engine='v1'")
    key = PK.pack_coords(pc.coords, pc.mask)
    n_bad = int((PK.is_sentinel_key(key) & pc.mask).sum())
    if n_bad:
        raise ValueError(
            f"{n_bad} valid point(s) outside the packed-key budget "
            f"(batch 0..{PK.BATCH_MAX}, coords {PK.COORD_MIN}.."
            f"{PK.COORD_MAX}); use engine='v1' for such clouds")
    sorted_keys, perm = torch.sort(key, stable=True)
    return SortedCloud(pc, sorted_keys, perm)


def downsample_sorted(sc: SortedCloud, factor: int = 2) -> SortedCloud:
    """Output cloud of a strided conv from the packed keys: quantize in the
    key domain, sort, keep first occurrences, compact them to the front.
    The result arrives sorted (identity perm)."""
    new_stride = sc.pc.stride * factor
    s, _ = torch.sort(PK.quantize_keys(sc.sorted_keys, new_stride))
    is_first = torch.ones_like(s, dtype=torch.bool)
    is_first[1:] = s[1:] != s[:-1]
    valid = is_first & ~PK.is_sentinel_key(s)
    kept = s[valid]
    n = s.shape[0]
    keys = torch.full_like(s, PK.KEY_SENTINEL)
    keys[:kept.shape[0]] = kept
    mask = torch.arange(n, device=s.device) < kept.shape[0]
    pc = PointCloud(PK.unpack_keys(keys), mask, new_stride)
    return SortedCloud(pc, keys, torch.arange(n, device=s.device))


def _shifted_keys(query_pc: PointCloud, offsets) -> torch.Tensor:
    """(K, M) keys of query coords shifted by each offset (batch col kept);
    masked query rows give the sentinel."""
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int64,
                           device=query_pc.coords.device)
    c = query_pc.coords.to(torch.int64)
    q = torch.cat([c[None, :, :1].expand(offs.shape[0], -1, -1),
                   c[None, :, 1:] + offs[:, None, :]], dim=-1)
    return PK.pack_coords(q, query_pc.mask[None, :])


def _lookup(sc: SortedCloud, q: torch.Tensor) -> torch.Tensor:
    """Row of `sc.pc` holding each query key, or -1 (int32)."""
    n = sc.pc.capacity
    posc = PK.searchsorted(sc.sorted_keys, q).clamp_(0, n - 1)
    hit = (sc.sorted_keys[posc] == q) & ~PK.is_sentinel_key(q)
    return torch.where(hit, sc.perm[posc], -1).to(torch.int32)


def match_table(sc: SortedCloud, query_pc: PointCloud,
                offsets) -> torch.Tensor:
    """table[k, j] = row of sc.pc at coords (query_pc.coords[j] +
    offsets[k]), or -1 when that site is absent."""
    return _lookup(sc, _shifted_keys(query_pc, offsets))


def kernel_map_v2(in_sc: SortedCloud, out_pc: PointCloud, kernel_size: int,
                  cap: int | None = None) -> KernelMaps:
    """Kernel maps by binary search: output q under offset delta is fed by
    the input at q + delta.  The hit table is the inverse table `inv`
    while `cap` keeps every match."""
    offs = kernel_offsets(kernel_size, 3, in_sc.pc.stride)
    m = out_pc.capacity
    cap = cap if cap is not None else min(in_sc.pc.capacity, m)
    in_idx = match_table(in_sc, out_pc, offs)
    hit = in_idx >= 0
    rows = torch.arange(m, dtype=torch.int32, device=hit.device)
    out_idx = torch.where(hit, rows, -1).to(torch.int32)
    inv = in_idx if cap >= m else None
    if cap < m:
        # explicit small cap: compact matches to the front, stably
        _, order = torch.sort((~hit).to(torch.int32), dim=1, stable=True)
        in_idx = in_idx.gather(1, order)
        out_idx = out_idx.gather(1, order)
        hit = hit.gather(1, order)
    if cap != m:
        in_idx = _fit_cols(in_idx, cap, -1)
        out_idx = _fit_cols(out_idx, cap, -1)
        hit = _fit_cols(hit, cap, False)
    return KernelMaps(in_idx, out_idx, hit, offs, inv=inv)


def _fit_cols(a: torch.Tensor, cap: int, fill) -> torch.Tensor:
    if cap <= a.shape[1]:
        return a[:, :cap]
    pad = torch.full((a.shape[0], cap - a.shape[1]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def build_conv_maps_cached(sc: SortedCloud, kernel_size: int, stride: int,
                           cap: int | None = None,
                           out_sc: SortedCloud | None = None):
    """(maps, out_sorted_cloud) against an existing SortedCloud.  Strided
    maps also carry the swapped inverse table `inv_t`, exact while `cap`
    drops no match."""
    if out_sc is None:
        out_sc = sc if stride == 1 else downsample_sorted(sc, stride)
    maps = kernel_map_v2(sc, out_sc.pc, kernel_size, cap=cap)
    resolved_cap = cap if cap is not None else min(sc.pc.capacity,
                                                   out_sc.pc.capacity)
    if stride > 1 and resolved_cap >= out_sc.pc.capacity:
        maps = maps._replace(inv_t=match_table(out_sc, sc.pc, -maps.offsets))
    return maps, out_sc


def build_conv_maps(in_pc: PointCloud, kernel_size: int, stride: int,
                    cap: int | None = None, engine: str | None = None,
                    cache: SortedCloud | None = None):
    """Maps + output cloud for a (possibly strided) sparse convolution.
    stride 1 is a submanifold conv (output sites == input sites).

    engine: "v2" (packed keys, the default) or "v1" (lexicographic sorts,
    any spatial dimensionality and coordinate range).  The default falls
    back to v1 for clouds that are not 3-D; an explicit engine="v2"
    raises there instead (a silent downgrade would defeat
    cross-checking).  `cache` is an existing SortedCloud of `in_pc` (v2)."""
    requested = engine
    engine = engine or DEFAULT_ENGINE
    if engine == "v2" and in_pc.ndim_spatial != 3 and requested is None:
        engine = "v1"
    if engine == "v2":
        sc = cache if cache is not None else sort_cloud(in_pc)
        maps, out_sc = build_conv_maps_cached(sc, kernel_size, stride,
                                              cap=cap)
        return maps, out_sc.pc
    if engine != "v1":
        raise ValueError(f"unknown mapping engine {engine!r}")
    out_pc = in_pc if stride == 1 else downsample(in_pc, stride)
    return kernel_map(in_pc, out_pc, kernel_size, cap=cap), out_pc
