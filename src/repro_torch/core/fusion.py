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
group.  `plan_conv_epilogue` is the reference's conv-epilogue planner (the
same plans at the same budget); the CUDA conv kernels fold every epilogue
whatever it says (`core/sparseconv.py`).
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


# candidate feature cache-block sizes (rows) for a streamed conv kernel,
# multiples of 8, largest first (fewest window sweeps)
CONV_FEAT_TILES = (65536, 32768, 16384, 8192, 4096, 2048, 1024, 512, 256,
                   128, 64, 32, 16, 8)


@dataclass(frozen=True)
class ConvFusionPlan:
    """Compile-time decision for one sparse conv + epilogue site."""

    fuse: bool            # fold the epilogue into the kernel flush?
    feat_tile: int        # feature cache-block rows (streaming window)
    out_tile: int         # output-stationary tile rows
    onchip_bytes: int     # estimated on-chip footprint of the fused group


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def plan_conv_epilogue(n_in: int, cin: int, cout: int, k: int, *,
                       residual: bool = False, out_tile: int = 128,
                       budget_bytes: int = DEFAULT_ONCHIP_BUDGET_BYTES,
                       dtype_bytes: int = 4) -> ConvFusionPlan:
    """Fusion plan for one sparse conv of K=`k` offsets, (cin -> cout)
    channels over an `n_in`-row input cloud.

    Resident regardless of cache block: all K weight tiles, the f32
    accumulator, the output tile, the inverse-table slice, and (if fused)
    the epilogue operands (a residual skip tile and the per-channel
    norm/bias vectors).  The feature cache block is double-buffered.
    """
    weights = k * cin * cout * dtype_bytes
    acc = out_tile * cout * 4                     # f32 scratch
    out_t = out_tile * cout * dtype_bytes
    inv = k * out_tile * 4
    epi = (out_tile * cout * dtype_bytes if residual else 0) \
        + 3 * cout * dtype_bytes + out_tile * dtype_bytes
    fixed = weights + acc + out_t + inv + epi
    # whole cloud resident first (one window, no sweeps), then shrinking
    # stream blocks: the largest fitting block wins
    candidates = [_round_up(n_in, 8)] + [t for t in CONV_FEAT_TILES
                                         if t < n_in]
    for tile in candidates:
        b = fixed + 2 * tile * cin * dtype_bytes  # double-buffered window
        if b <= budget_bytes:
            return ConvFusionPlan(True, tile, out_tile, b)
    # the epilogue operands do not fit next to the conv: stream the conv
    # with the smallest block and run the epilogue layer by layer (the
    # paper's "discard the last layer and fuse the remaining ones")
    tile = candidates[-1]
    b = fixed - epi + 2 * tile * cin * dtype_bytes
    return ConvFusionPlan(False, tile, out_tile, b)


def dram_bytes_conv_epilogue(n_out: int, cout: int, *, residual: bool =
                             False, fused: bool = True,
                             dtype_bytes: int = 4) -> int:
    """Epilogue-side DRAM traffic of one sparse conv layer (the Fig. 20
    model applied to conv blocks).  Unfused: the kernel writes the
    pre-activation accumulator, the epilogue reads it back and writes the
    activation (plus a residual read).  Fused: only the final activation is
    written (the residual skip tile is still read once)."""
    act = n_out * cout * dtype_bytes
    res = act if residual else 0
    if fused:
        return act + res
    return 3 * act + res


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
