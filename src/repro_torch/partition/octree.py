"""Octree chunking over packed keys: recursive range splitting of the
level-0 ranking order into budget-bounded, spatially-local chunks.

The 62-bit packed key (repro_torch.core.packed: batch | x | y | z, biased
fields) is itself a space-filling ordering — ascending key order is the
raster-scan curve over (batch, x, y, z).  Every prefix of the key bits
therefore names a contiguous KEY RANGE: descending the key's bit trie is
the raster-order analogue of descending an octree (batch planes first,
then x halves, then y, then z), and a trie cell is exactly one contiguous
slice of the already-sorted key array.  Splitting is therefore pure
binary search over the one level-0 ranking pass the planner already ran —
no re-sorting, no data movement, and equal keys (duplicate voxels) can
never be separated because they share every bit.

`split_ranges` is the whole algorithm: descend the trie, emit a leaf as
soon as its population fits the point budget, keep splitting otherwise.
Degenerate ranges that exhaust all 62 bits (every key identical) are
emitted as-is — the plan's capacity check catches them loudly rather than
this module splitting a voxel in half silently.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import packed as PK

# Highest bit of the logical key (bit 61: top of the 14-bit batch field).
_TOP_BIT = PK.KEY64_BITS - 1


def split_ranges(keys_sorted: np.ndarray, budget: int) -> list[tuple[int, int]]:
    """Split an ascending uint64 key array into contiguous ranges of at
    most `budget` points each, along packed-key trie (octree) cell
    boundaries.

    Returns [(start, end), ...] half-open index ranges, ascending and
    exactly covering [0, len(keys_sorted)).  Equal keys always land in
    the same range; a range whose keys are ALL equal is emitted even when
    it exceeds the budget (the caller decides whether an over-populated
    single voxel is an error).
    """
    keys_sorted = np.asarray(keys_sorted, np.uint64)
    n = int(keys_sorted.shape[0])
    if budget < 1:
        raise ValueError(f"chunk budget must be >= 1, got {budget}")
    if n == 0:
        return []
    out: list[tuple[int, int]] = []
    stack = [(0, n, _TOP_BIT)]
    while stack:
        s, e, bit = stack.pop()
        if e - s <= budget or bit < 0:
            out.append((s, e))
            continue
        # keys in [s, e) share every bit above `bit`; the boundary between
        # the bit=0 and bit=1 halves of this trie cell is one binary search
        one = np.uint64(1) << np.uint64(bit)
        prefix = keys_sorted[s] & ~(one | (one - np.uint64(1)))
        mid = s + int(np.searchsorted(keys_sorted[s:e], prefix | one,
                                      side="left"))
        if mid == s or mid == e:
            stack.append((s, e, bit - 1))
        else:
            stack.append((mid, e, bit - 1))
            stack.append((s, mid, bit - 1))
    out.sort()
    return out


def rank_keys(coords, mask) -> tuple[np.ndarray, np.ndarray, int]:
    """The planner's one level-0 ranking pass, on the host.

    Returns `(keys_sorted, order, n_valid)`: uint64 packed keys in
    ascending order (sentinels at the end), the stable permutation
    original-row -> sorted position inverse (`order[i]` = original row at
    sorted position i), and the count of valid (non-sentinel) keys.
    Everything downstream — trie splitting, halo searches, the stride
    pyramid — reuses this single sort.
    """
    keys = PK.pack_coords_host(coords, mask)
    order = np.argsort(keys, kind="stable").astype(np.int64)
    keys_sorted = keys[order]
    n_valid = int(np.searchsorted(keys_sorted, PK.KEY64_SENTINEL,
                                  side="left"))
    return keys_sorted, order, n_valid
