"""Packed coordinate keys on one int64 (the v2 ranking engine's key domain).

A (batch, x, y, z) coordinate packs into one 62-bit key:

    bit 61..48   batch  (14 bits, unsigned,  0 .. 16383)
    bit 47..32   x+2^15 (16 bits, biased,   -32768 .. 32767)
    bit 31..16   y+2^15 (16 bits, biased)
    bit 15..0    z+2^15 (16 bits, biased)

The reference keeps the same key as an (int32 hi, uint32 lo) word pair
because int64 is second-class on its backend; here it is one signed int64,
`(hi << 32) | lo`.  Valid keys are < 2^62, so signed int64 order equals the
reference's lexicographic (hi, lo) order, and a stable sort of the int64
keys gives the identical permutation.  The sentinel (masked rows, or
coordinates outside the per-field budget) is 2^63-1: the reference's
(2^31-1, 2^32-1) word pair, composed, and int64's maximum — it sorts last
and equals no valid key.  `key_words` splits a key back into the
reference's word pair for exact comparison.
"""

from __future__ import annotations

import numpy as np
import torch

# Coordinate-domain sentinel (shared with repro_torch.core.mapping.SENTINEL).
COORD_SENTINEL = 2**30 - 1

BATCH_BITS = 14
SPATIAL_BITS = 16
BIAS = 1 << (SPATIAL_BITS - 1)              # 32768
COORD_MIN = -BIAS                           # -32768
COORD_MAX = BIAS - 1                        # 32767
BATCH_MAX = (1 << BATCH_BITS) - 1           # 16383

KEY_SENTINEL = 2**63 - 1

_FIELD = (1 << SPATIAL_BITS) - 1


def pack_coords(coords: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 4) integer coords -> (...,) int64 packed keys.

    Computed in int64, so an out-of-range lane cannot wrap into a valid
    key before the `ok` mask replaces it with the sentinel.
    """
    c = coords.to(torch.int64)
    b, x, y, z = c.unbind(-1)
    ok = (b >= 0) & (b <= BATCH_MAX)
    for v in (x, y, z):
        ok = ok & (v >= COORD_MIN) & (v <= COORD_MAX)
    if mask is not None:
        ok = ok & mask
    key = ((b << (3 * SPATIAL_BITS)) | ((x + BIAS) << (2 * SPATIAL_BITS))
           | ((y + BIAS) << SPATIAL_BITS) | (z + BIAS))
    return torch.where(ok, key, torch.full_like(key, KEY_SENTINEL))


def is_sentinel_key(key: torch.Tensor) -> torch.Tensor:
    return key == KEY_SENTINEL


def unpack_keys(key: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_coords`: (...,) int64 -> (..., 4) int32 coords.
    Sentinel keys unpack to all-COORD_SENTINEL rows."""
    b = key >> (3 * SPATIAL_BITS)
    x = ((key >> (2 * SPATIAL_BITS)) & _FIELD) - BIAS
    y = ((key >> SPATIAL_BITS) & _FIELD) - BIAS
    z = (key & _FIELD) - BIAS
    coords = torch.stack([b, x, y, z], dim=-1).to(torch.int32)
    sent = torch.full_like(coords, COORD_SENTINEL)
    return torch.where(is_sentinel_key(key)[..., None], sent, coords)


def quantize_keys(key: torch.Tensor, stride: int) -> torch.Tensor:
    """Clear the low log2(stride) bits of every spatial field in the key
    domain (the bias 2^15 is divisible by every such stride, so this is
    quantize-then-pack).  Sentinel keys are preserved."""
    if stride == 1:
        return key
    k = int(np.log2(stride))
    if 2 ** k != stride:
        raise ValueError(f"stride must be a power of two, got {stride}")
    if k > SPATIAL_BITS - 1:
        raise ValueError(f"stride {stride} exceeds the per-axis bit budget")
    low = stride - 1
    clear = (low << (2 * SPATIAL_BITS)) | (low << SPATIAL_BITS) | low
    q = key & ~clear
    return torch.where(is_sentinel_key(key), key, q)


def key_words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi int32, lo uint32 held in int64): the reference's word pair."""
    return (key >> 32).to(torch.int32), key & 0xFFFFFFFF


def searchsorted(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """side='left' positions of query keys (any shape) in an ascending
    int64 key array: the reference's `searchsorted_pair`, on one word."""
    return torch.searchsorted(sorted_keys, q.contiguous(), side="left")


# -- host-side (numpy) key helpers ------------------------------------------
#
# The partition planner (repro_torch.partition) ranks and range-splits
# city-scale clouds on the host, where shapes are dynamic and a device
# round trip per binary search would dominate.  These mirror the packing
# above in one uint64 word, bit for bit with the reference's host helpers:
# a valid key is below 2^62, so unsigned uint64 order is the logical key
# order, and the sentinel is KEY_SENTINEL (2^63 - 1) as a uint64.

KEY64_BITS = BATCH_BITS + 3 * SPATIAL_BITS          # 62
KEY64_SENTINEL = np.uint64(KEY_SENTINEL)


def compose_key64(hi, lo) -> np.ndarray:
    """(hi int32, lo uint32) word pairs -> one uint64 key, order-preserving
    (valid hi is never negative)."""
    return ((np.asarray(hi).astype(np.int64).astype(np.uint64)
             << np.uint64(32))
            | np.asarray(lo, np.uint32).astype(np.uint64))


def pack_coords_host(coords, mask=None) -> np.ndarray:
    """Host mirror of `pack_coords`: (..., 4) integer coords -> (...,)
    uint64 keys with out-of-budget / masked rows saturated to
    KEY64_SENTINEL."""
    coords = np.asarray(coords)
    b = coords[..., 0].astype(np.int64)
    x = coords[..., 1].astype(np.int64)
    y = coords[..., 2].astype(np.int64)
    z = coords[..., 3].astype(np.int64)
    ok = (b >= 0) & (b <= BATCH_MAX)
    for c in (x, y, z):
        ok = ok & (c >= COORD_MIN) & (c <= COORD_MAX)
    if mask is not None:
        ok = ok & np.asarray(mask, bool)
    key = ((b << (3 * SPATIAL_BITS))
           | ((x + BIAS) << (2 * SPATIAL_BITS))
           | ((y + BIAS) << SPATIAL_BITS)
           | (z + BIAS)).astype(np.uint64)
    return np.where(ok, key, KEY64_SENTINEL)


def unpack_key64(keys) -> np.ndarray:
    """Inverse of `pack_coords_host`: (...,) uint64 -> (..., 4) int32
    coords; sentinel keys unpack to all-COORD_SENTINEL rows."""
    keys = np.asarray(keys, np.uint64)
    k = keys.astype(np.int64)
    b = k >> (3 * SPATIAL_BITS)
    x = ((k >> (2 * SPATIAL_BITS)) & _FIELD) - BIAS
    y = ((k >> SPATIAL_BITS) & _FIELD) - BIAS
    z = (k & _FIELD) - BIAS
    coords = np.stack([b, x, y, z], axis=-1).astype(np.int32)
    return np.where((keys == KEY64_SENTINEL)[..., None],
                    np.int32(COORD_SENTINEL), coords)


def quantize_key64(keys, stride: int) -> np.ndarray:
    """Host mirror of `quantize_keys` on uint64 keys: clear the low
    log2(stride) bits of each 16-bit spatial field; sentinels preserved."""
    if stride == 1:
        return np.asarray(keys, np.uint64)
    k = int(np.log2(stride))
    if 2 ** k != stride:
        raise ValueError(f"stride must be a power of two, got {stride}")
    if k > SPATIAL_BITS - 1:
        raise ValueError(f"stride {stride} exceeds the per-axis bit budget")
    low = stride - 1
    clear = np.uint64((low << (2 * SPATIAL_BITS)) | (low << SPATIAL_BITS)
                      | low)
    keys = np.asarray(keys, np.uint64)
    q = keys & ~clear
    return np.where(keys == KEY64_SENTINEL, KEY64_SENTINEL, q)
