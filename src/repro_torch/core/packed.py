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
