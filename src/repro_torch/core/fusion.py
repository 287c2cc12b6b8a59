"""Temporal layer fusion planner (PointAcc section 4.2.4).

PointAcc fuses consecutive FC layers by tiling the point dimension (FCs are
pointwise, so no halos) and keeping intermediates on chip.  The number of
fused layers is chosen at compile time: "for each set of consecutive FCs,
try to fuse all unprocessed FCs.  If the estimated memory of required
intermediate data overflows for all possible tilings, discard the last
layer and try to fuse the remaining ones."

The same search and cost model as the reference's `core/fusion.py`: given
the same arguments it returns the same groups.  Only the default budget
differs: the port plans against one block's shared memory on the H100.
The plan drives `kernels.fused_mlp.ops.fused_mlp_chain`, one launch per
group.  The conv-epilogue planner and window schedule are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

# NVIDIA H100: 227 KB (232,448 bytes) of shared memory a block can use.
DEFAULT_ONCHIP_BUDGET_BYTES = 232448
# candidate point-dim tile sizes of the planner's cost model
CANDIDATE_TILES = (4096, 2048, 1024, 512, 256, 128)


@dataclass(frozen=True)
class FusionGroup:
    start: int            # first layer index in the chain
    n_layers: int         # how many consecutive FCs are fused
    tile_points: int      # point-dim tile size of the cost model
    onchip_bytes: int     # estimated on-chip footprint of the group


def _group_bytes(widths: Sequence[int], tile: int, dtype_bytes: int) -> int:
    """On-chip bytes for one tile flowing through the fused chain: every
    inter-layer activation tile live at once plus every fused weight."""
    acts = sum(w * tile for w in widths) * dtype_bytes
    weights = sum(widths[i] * widths[i + 1]
                  for i in range(len(widths) - 1)) * dtype_bytes
    return acts + weights


def plan_fusion(layer_widths: Sequence[int],
                budget_bytes: int = DEFAULT_ONCHIP_BUDGET_BYTES,
                dtype_bytes: int = 4) -> List[FusionGroup]:
    """layer_widths: [in, h1, h2, ..., out] for a chain of len-1 FC layers.

    Greedy longest-prefix fusion under the budget: try all layers, shrink
    the tiling, then drop the last layer.
    """
    n_fcs = len(layer_widths) - 1
    groups: List[FusionGroup] = []
    start = 0
    while start < n_fcs:
        placed = False
        for n in range(n_fcs - start, 0, -1):
            widths = layer_widths[start:start + n + 1]
            for tile in CANDIDATE_TILES:
                b = _group_bytes(widths, tile, dtype_bytes)
                if b <= budget_bytes:
                    groups.append(FusionGroup(start, n, tile, b))
                    start += n
                    placed = True
                    break
            if placed:
                break
        if not placed:
            # even a single layer at the smallest tile overflows: emit it
            # alone at the smallest tile (its weights stream)
            widths = layer_widths[start:start + 2]
            groups.append(FusionGroup(
                start, 1, CANDIDATE_TILES[-1],
                _group_bytes(widths, CANDIDATE_TILES[-1], dtype_bytes)))
            start += 1
    return groups


def dram_bytes_unfused(n_points: int, layer_widths: Sequence[int],
                       dtype_bytes: int = 4) -> int:
    """Layer-by-layer execution: every intermediate activation is written to
    and read back from DRAM (paper Fig. 20 baseline)."""
    total = n_points * layer_widths[0] * dtype_bytes       # initial read
    for w in layer_widths[1:-1]:
        total += 2 * n_points * w * dtype_bytes            # write + read
    total += n_points * layer_widths[-1] * dtype_bytes     # final write
    total += sum(layer_widths[i] * layer_widths[i + 1]
                 for i in range(len(layer_widths) - 1)) * dtype_bytes
    return total


def dram_bytes_fused(n_points: int, layer_widths: Sequence[int],
                     groups: Sequence[FusionGroup],
                     dtype_bytes: int = 4) -> int:
    """With temporal fusion only group-boundary activations touch DRAM."""
    total = n_points * layer_widths[0] * dtype_bytes
    for g in groups[:-1]:
        boundary = layer_widths[g.start + g.n_layers]
        total += 2 * n_points * boundary * dtype_bytes
    total += n_points * layer_widths[-1] * dtype_bytes
    # weights are read once per group
    for g in groups:
        widths = layer_widths[g.start:g.start + g.n_layers + 1]
        w_bytes = sum(widths[i] * widths[i + 1]
                      for i in range(len(widths) - 1)) * dtype_bytes
        total += w_bytes
    return total
