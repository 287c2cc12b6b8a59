"""Capacity-bucket policy for serving point-cloud scenes.

Scenes are padded up to a small geometric set of capacities, so the
number of distinct shapes the model sees is bounded by the number of
buckets while the padding per scene is bounded by the ladder's growth
factor.  `pad_scene` pads rows with SENTINEL coordinates and a False mask,
which the mapping treats as "not a point", so valid-row outputs do not
change.  A copy of the reference's `serve/buckets.py` (numpy only).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.packed import COORD_SENTINEL as SENTINEL

DEFAULT_MAX_BATCH = 4


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """An ascending tuple of scene capacities, with an optional
    per-capacity micro-batch width `max_batch`."""

    capacities: tuple[int, ...]
    max_batch: tuple[int, ...] | None = None

    def __post_init__(self):
        caps = tuple(int(c) for c in self.capacities)
        if not caps or any(c <= 0 for c in caps):
            raise ValueError("BucketLadder needs positive capacities, got "
                             f"{self.capacities}")
        if list(caps) != sorted(set(caps)):
            raise ValueError("BucketLadder capacities must be strictly "
                             f"ascending, got {self.capacities}")
        object.__setattr__(self, "capacities", caps)
        if self.max_batch is not None:
            mb = tuple(int(b) for b in self.max_batch)
            if len(mb) != len(caps) or any(b < 1 for b in mb):
                raise ValueError(
                    "BucketLadder max_batch needs one positive width per "
                    f"capacity, got {self.max_batch} for {caps}")
            object.__setattr__(self, "max_batch", mb)

    @property
    def n_buckets(self) -> int:
        return len(self.capacities)

    def index_for(self, n_points: int) -> int:
        """Index of the smallest bucket holding an n_points-row scene."""
        for i, cap in enumerate(self.capacities):
            if n_points <= cap:
                return i
        raise ValueError(
            f"scene with {n_points} points exceeds the bucket ladder "
            f"(max capacity {self.capacities[-1]}); extend the ladder")

    def bucket_for(self, n_points: int) -> int:
        """Capacity of the smallest bucket holding the scene."""
        return self.capacities[self.index_for(n_points)]

    def fits(self, n_points: int) -> bool:
        """Non-raising probe: does an n_points-row scene fit the ladder?"""
        return 0 <= n_points <= self.capacities[-1]

    def padding_fraction(self, n_points: int) -> float:
        """Wasted fraction of the bucket a scene of n_points rows pays."""
        return 1.0 - n_points / self.bucket_for(n_points)


def geometric_ladder(min_capacity: int = 128, max_capacity: int = 65536,
                     growth: float = 2.0) -> BucketLadder:
    """Geometric capacity ladder (worst-case padding 1 - 1/growth), with
    capacities rounded up to multiples of 8."""
    if growth <= 1.0:
        raise ValueError(f"ladder growth must be > 1, got {growth}")
    caps, c = [], float(min_capacity)
    while True:
        cap = int(8 * math.ceil(c / 8))
        if not caps or cap > caps[-1]:
            caps.append(cap)
        if cap >= max_capacity:
            break
        c *= growth
    return BucketLadder(tuple(caps))


DEFAULT_LADDER = geometric_ladder()


def resolve_max_batch(spec, ladder: BucketLadder) -> tuple[int, dict]:
    """(default_width, {capacity: width}) from an int, a {capacity: width}
    dict (optional "default" key), or None (the ladder's own `max_batch`,
    else DEFAULT_MAX_BATCH).  Override capacities must be on the ladder."""
    if spec is None:
        if ladder.max_batch is not None:
            return (DEFAULT_MAX_BATCH,
                    dict(zip(ladder.capacities, ladder.max_batch)))
        return DEFAULT_MAX_BATCH, {}
    if isinstance(spec, dict):
        overrides = dict(spec)
        default = int(overrides.pop("default", DEFAULT_MAX_BATCH))
        unknown = [c for c in overrides if int(c) not in ladder.capacities]
        if unknown:
            raise ValueError(
                f"max_batch overrides for capacities {unknown} not on the "
                f"ladder {ladder.capacities}")
        overrides = {int(c): int(b) for c, b in overrides.items()}
        widths = [default, *overrides.values()]
    else:
        default, overrides, widths = int(spec), {}, [int(spec)]
    if any(b < 1 for b in widths):
        raise ValueError(f"max_batch must be >= 1, got {spec}")
    return default, overrides


def max_batch_from_occupancy(bucket_stats: dict, default: int =
                             DEFAULT_MAX_BATCH, floor: int = 1) -> dict:
    """Seed per-bucket max_batch overrides from serving telemetry.

    `bucket_stats` is `ServeScheduler.stats()["buckets"]`; each bucket's
    suggested width is its observed mean real scenes per micro-batch
    (rounded up), clamped to [floor, default]: a bucket that mostly ran
    dummy-filled stops waiting for a full wide batch, a busy bucket keeps
    the full width.  Feed the result back as `ServeScheduler(max_batch=
    {**overrides, "default": default})` or `BucketLadder(caps,
    max_batch=...)`.
    """
    out = {}
    for cap, b in bucket_stats.items():
        seen = math.ceil(b["scenes"] / b["batches"]) if b["batches"] else \
            default
        out[int(cap)] = max(floor, min(default, seen))
    return out


def pad_scene(coords, mask, feats, capacity: int):
    """Pad one scene's (coords, mask, feats) rows up to `capacity` on the
    host: invalid rows (padding and masked rows) get SENTINEL coordinates
    and zero features."""
    coords = np.asarray(coords)
    mask = np.asarray(mask, bool)
    n = coords.shape[0]
    if capacity < n:
        raise ValueError(f"cannot pad a {n}-row scene down to {capacity}")
    out_c = np.full((capacity, coords.shape[1]), SENTINEL, np.int32)
    out_c[:n] = np.where(mask[:, None], coords.astype(np.int32), SENTINEL)
    out_m = np.zeros(capacity, bool)
    out_m[:n] = mask
    if feats is None:
        return out_c, out_m, None
    feats = np.asarray(feats)
    out_f = np.zeros((capacity,) + feats.shape[1:], feats.dtype)
    out_f[:n] = np.where(mask.reshape((n,) + (1,) * (feats.ndim - 1)),
                         feats, 0)
    return out_c, out_m, out_f
