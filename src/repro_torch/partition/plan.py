"""PartitionPlan: octree chunks, halo'd, served as ordinary scenes.

`plan_partition` turns one oversized scene into a `PartitionPlan`:

  1. one host ranking pass (`octree.rank_keys` — the level-0 sort every
     downstream structure reuses);
  2. trie range splitting into interior chunks of at most
     `chunk_budget` points (`octree.split_ranges`);
  3. exact needed-input marks for every chunk in one propagation pass
     (`halo.needed_marks` over the full cloud's stride pyramid);
  4. chunk assembly: each chunk's rows = its needed points in packed-key
     order (interior + halo), small enough for the bucket ladder — a
     chunk whose halo overflows the top bucket halves the budget and
     replans.

The plan then `run`s against anything with the serve submit/flush/take
surface (`ServeScheduler`, `ServeRouter`): chunks are admitted as
ordinary scenes — they pad to ladder buckets, micro-batch with their
peers, hit the mapping/assembly caches by geometry digest (repeated
chunks keep their warm worker under digest-affinity routing) — and the
per-chunk predictions are stitched back into the caller's row order with
every halo row dropped.  Interior outputs are exact (see `halo`), so the
stitched result equals the monolithic network's output on every valid
row.  The chunks are host numpy arrays, as in the reference; the target's
engines move them to their device.  On the card the tensor-core sparse
conv decides on the device how many ranks share a row tile from a level's
live tiles (`kernels.spconv.spconv.round_groups`), and a chunk has other
live tiles than the whole scene, so its float32 sums may run in another
order: there a label may differ from the monolithic one where the two top
logits are within float32 rounding of each other.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.partition import halo as HL
from repro_torch.partition import octree as OC


@dataclasses.dataclass(frozen=True)
class PartitionPolicy:
    """Partition policy knobs for `PointCloudEngine.segment(partition=)`.

    chunk_budget — target INTERIOR points per chunk (halo rides on top);
                   None derives half the ladder's top bucket, leaving the
                   other half as halo headroom.
    force        — partition even when the scene fits the ladder (parity
                   tests and benchmarks chunk small scenes on purpose).
    max_attempts — budget halvings allowed when a chunk's interior+halo
                   overflows the top bucket before planning fails loudly.
    """

    chunk_budget: int | None = None
    force: bool = False
    max_attempts: int = 6


@dataclasses.dataclass
class Chunk:
    """One bucket-sized scene cut from the big cloud (valid rows only,
    in packed-key order: interior + halo interleaved by key)."""

    coords: np.ndarray      # (m, 4) int32
    mask: np.ndarray        # (m,) bool, all True
    feats: np.ndarray       # (m, C)
    rows: np.ndarray        # (m,) original scene row of each chunk row
    interior: np.ndarray    # (m,) bool — False rows are halo, dropped

    @property
    def n_points(self) -> int:
        return int(self.coords.shape[0])

    @property
    def n_halo(self) -> int:
        return int((~self.interior).sum())


@dataclasses.dataclass
class PartitionPlan:
    """Chunks plus the stitch back into scene order."""

    chunks: list[Chunk]
    n_rows: int             # original scene row count
    n_valid: int
    budget: int             # interior budget the final split used
    spec: HL.HaloSpec

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def halo_rows(self) -> int:
        return sum(c.n_halo for c in self.chunks)

    @property
    def halo_fraction(self) -> float:
        total = sum(c.n_points for c in self.chunks)
        return self.halo_rows / total if total else 0.0

    def stats(self) -> dict:
        sizes = [c.n_points for c in self.chunks]
        return {"n_chunks": self.n_chunks, "n_valid": self.n_valid,
                "budget": self.budget, "halo_rows": self.halo_rows,
                "halo_fraction": self.halo_fraction,
                "max_chunk_points": max(sizes, default=0),
                "chunk_points": sizes}

    def stitch(self, preds_by_chunk) -> np.ndarray:
        """Per-chunk predictions -> (n_rows,) scene-order class ids.
        Halo rows are dropped; rows no chunk owned (invalid/masked rows,
        or chunks that failed) stay -1 — never a valid class id."""
        out = np.full(self.n_rows, -1, np.int32)
        for chunk, preds in zip(self.chunks, preds_by_chunk):
            if preds is None:
                continue
            preds = np.asarray(preds)
            sel = chunk.interior
            out[chunk.rows[sel]] = preds[sel]
        return out

    def run(self, target, tracer=None, trace_id=None):
        """Serve every chunk through `target` (a `ServeScheduler` or
        `ServeRouter`: anything with submit/flush/take) and stitch.

        Returns `(preds, mapping_hit, errors)`: scene-order predictions
        (-1 on rows of failed chunks), whether every completed chunk's
        pyramid came from the mapping cache, and {chunk_index:
        ServeError} for chunks that completed with a typed error.

        With a `repro_torch.obs.SpanTracer` and a begun `trace_id`, the
        fan-out and stitch phases land as spans on that trace (each
        chunk additionally owns an ordinary per-request trace in the
        target's scheduler; the fan-out span carries their rids for
        cross-referencing).
        """
        tr = tracer if trace_id is not None else None
        t0 = time.monotonic()
        rids = [target.submit(c.coords, c.feats, c.mask)
                for c in self.chunks]
        if tr is not None:
            tr.span(trace_id, "chunk_fanout", t_start=t0,
                    t_end=time.monotonic(), n_chunks=len(self.chunks),
                    rids=list(rids))
        target.flush()
        by_rid = target.take(rids)
        errors = {i: by_rid[r].error for i, r in enumerate(rids)
                  if by_rid[r].error is not None}
        t1 = time.monotonic()
        preds = self.stitch([None if i in errors
                             else by_rid[r].preds
                             for i, r in enumerate(rids)])
        if tr is not None:
            tr.span(trace_id, "stitch", t_start=t1,
                    t_end=time.monotonic(), n_errors=len(errors))
        hit = all(by_rid[r].mapping_hit for i, r in enumerate(rids)
                  if i not in errors) if len(errors) < len(rids) else False
        return preds, hit, errors


def plan_partition(coords, mask, feats, *, spec: HL.HaloSpec, ladder,
                   policy: PartitionPolicy | None = None) -> PartitionPlan:
    """Build a `PartitionPlan` for one (coords, mask, feats) scene."""
    policy = policy or PartitionPolicy()
    coords = np.asarray(coords)
    feats = np.asarray(feats)
    n_rows = coords.shape[0]
    mask = np.ones(n_rows, bool) if mask is None else np.asarray(mask, bool)
    if coords.ndim != 2 or coords.shape[1] != 4:
        raise ValueError("partitioning needs (N, 4) coords (batch + 3 "
                         f"spatial dims), got {coords.shape}")

    keys_sorted, order, n_valid = OC.rank_keys(coords, mask)
    if n_valid == 0:
        return PartitionPlan([], n_rows, 0, 0, spec)
    valid_keys = keys_sorted[:n_valid]
    ukeys, uinv = np.unique(valid_keys, return_inverse=True)
    pyramid = HL.build_pyramid(ukeys, spec.n_stages)

    top = ladder.capacities[-1]
    budget = policy.chunk_budget if policy.chunk_budget is not None \
        else max(1, top // 2)
    if budget > top:
        raise ValueError(f"chunk_budget {budget} exceeds the ladder's top "
                         f"bucket ({top}); halo needs headroom below it")

    for attempt in range(policy.max_attempts):
        ranges = OC.split_ranges(valid_keys, budget)
        # equal keys never split, so unique-site ranges partition cleanly
        interior = np.zeros((ukeys.shape[0], len(ranges)), bool)
        for c, (s, e) in enumerate(ranges):
            interior[uinv[s]:uinv[e - 1] + 1, c] = True
        needed = HL.needed_marks(pyramid, spec, interior)

        chunks = []
        for c, (s, e) in enumerate(ranges):
            positions = np.flatnonzero(needed[uinv, c])
            if positions.shape[0] > top:
                chunks = None
                break
            rows = order[positions]
            chunks.append(Chunk(
                coords=np.ascontiguousarray(coords[rows]),
                mask=np.ones(positions.shape[0], bool),
                feats=np.ascontiguousarray(feats[rows]),
                rows=rows,
                interior=(positions >= s) & (positions < e)))
        if chunks is not None:
            return PartitionPlan(chunks, n_rows, n_valid, budget, spec)
        if budget == 1:
            break
        budget = max(1, budget // 2)
    raise ValueError(
        f"could not partition the scene into chunks fitting the top "
        f"bucket ({top}) within {policy.max_attempts} budget halvings — "
        f"the receptive-field halo outgrows the ladder; extend the "
        f"ladder or shrink the network's receptive field")
