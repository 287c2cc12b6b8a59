"""Point-cloud serving engine: MinkUNet segmentation behind a bucket ladder
and a digest-keyed mapping cache.

  * `segment(coords, mask, feats)` — one scene: padded to its ladder
    bucket, level pyramid served from the mapping cache (keyed by the
    padded coordinates), forward, argmax, predictions sliced back to the
    caller's row count.
  * `segment_batch(coords, mask, feats)` — (B, N, ...) scenes served
    through the engine's `serve.scheduler.ServeScheduler` (admitted,
    grouped into fixed-shape micro-batches per bucket, reassembled in
    submission order).
  * `levels_for(coords, mask)` — the cached mapping pass alone; the
    batched form gives the tuple of the scenes' cached pyramids.

The default flow is `"cuda_fused"`, so `segment` runs the hand-written
fused sparse-conv kernel on every conv (the reference's default is
`"fod"`).  Where the reference jits and vmaps its entry points, these are
eager calls: a micro-batch runs its scenes one after another through the
code `segment` runs, so its labels are bit-identical to `segment`'s.
`segment(partition=...)` opens the city-scale path: the scene is cut into
halo'd chunks on the host (`repro_torch.partition`), each served through
the engine's scheduler as an ordinary scene, and the labels stitched back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api import MappingCache, PointAccSession
from repro_torch.core import mapping as M
from repro_torch.device import resolve_device
from repro_torch.models import minkunet as MU
from repro_torch.models.params import ParamTree
from repro_torch.serve import buckets as BK


class PointCloudEngine:
    """Serving frontend for MinkUNet-style sparse segmentation models.

    `params_or_module` is a `models.minkunet.MinkUNet` or a parameter tree
    (nested dicts/lists of tensors).  The weights move to `device`: None
    resolves to the first CUDA device and raises when there is none;
    `device="cpu"` opts into the plain PyTorch versions of the kernels.
    `max_batch` / `mesh` / `fault_plan` / `obs` configure the scheduler
    behind `segment_batch` (mesh="auto" splits micro-batches over the
    host's CUDA devices, and serves on this one device when it is alone).
    """

    def __init__(self, params_or_module, n_stages: int,
                 flow: str = "cuda_fused", device=None,
                 engine: Optional[str] = None, cache_entries: int = 32,
                 ladder: Optional[BK.BucketLadder] = None,
                 max_batch=None, mesh="auto", fault_plan=None, obs=None):
        self.device = resolve_device(device)
        module = params_or_module if isinstance(params_or_module, ParamTree) \
            else MU.MinkUNet(params_or_module)
        self.module = module.to(self.device)
        self.session = PointAccSession(flow=flow, engine=engine,
                                       cache_entries=cache_entries)
        self.flow = flow
        self.engine = engine
        self.n_stages = n_stages
        self.ladder = ladder if ladder is not None else BK.DEFAULT_LADDER
        self._max_batch = max_batch
        self._mesh = mesh
        # chaos seam: a serve.faults.FaultPlan picked up by every scheduler
        # built over this engine (None = nothing injected)
        self.fault_plan = fault_plan
        # observability bundle (repro_torch.obs.Observability) for the
        # lazy default scheduler; None keeps it metrics-only
        self.obs = obs
        self._scheduler = None
        # partition telemetry: trace ids and the last plan's stats
        self._n_partitions = 0
        self.last_partition_stats = None
        # the distinct shapes each entry point has run (`compile_stats`)
        self._shapes = {"build": set(), "apply": set(), "apply_batch": set()}

    @classmethod
    def factory(cls, params_or_module, n_stages: int, **kwargs):
        """Zero-arg engine factory for pool owners: each call builds an
        engine with its own caches over the same weights and config."""

        def build() -> "PointCloudEngine":
            return cls(params_or_module, n_stages, **kwargs)

        return build

    def scheduler(self):
        """The engine's lazily-built default `ServeScheduler` (the one
        `segment_batch` serves through); build your own for another
        max_batch / pipeline depth / assembly-cache bound / deadline
        policy."""
        if self._scheduler is None:
            from repro_torch.serve.scheduler import ServeScheduler
            kwargs = {} if self.obs is None else {"obs": self.obs}
            self._scheduler = ServeScheduler(self, max_batch=self._max_batch,
                                             mesh=self._mesh, **kwargs)
        return self._scheduler

    # -- mapping ----------------------------------------------------------

    def scene_key(self, coords, mask, bucket: int) -> bytes:
        """Digest identifying one already-padded scene's level pyramid in
        the mapping cache (the same bytes as the reference's key)."""
        return MappingCache.digest((np.asarray(coords), np.asarray(mask)),
                                   extra=("levels", int(bucket)))

    def _levels_padded(self, coords, mask, bucket: int, key: bytes = None):
        """(levels, hit) for ONE already-padded scene; cached per scene."""
        coords = np.asarray(coords)
        mask = np.asarray(mask)
        if key is None:
            key = self.scene_key(coords, mask, bucket)
        return self.session.maps_cache.get_by_key(
            key, lambda: self._build(coords, mask))

    def _build(self, coords: np.ndarray, mask: np.ndarray):
        """The mapping pass over one padded scene, on the device."""
        self._shapes["build"].add(coords.shape)
        pc = M.PointCloud(torch.from_numpy(coords).to(self.device),
                          torch.from_numpy(mask).to(self.device), 1)
        return MU.build_unet_maps(pc, self.n_stages, engine=self.engine)

    def _scene_levels(self, coords, mask):
        """(levels, hit) for one raw scene: pad to its bucket, then the
        cached build."""
        cap = self.ladder.bucket_for(np.asarray(coords).shape[0])
        c, m, _ = BK.pad_scene(coords, mask, None, cap)
        return self._levels_padded(c, m, cap)

    def levels_for(self, coords, mask, batched: bool = False):
        """(level pyramid, cache_hit) for one geometry, built at the
        scene's bucket capacity (as `segment` pads it).  The batched form
        takes (B, N, ...) scenes and gives the tuple of their pyramids,
        each built and cached per scene, and a hit flag that is True only
        when every scene hit."""
        if not batched:
            return self._scene_levels(coords, mask)
        coords = np.asarray(coords)
        mask = np.asarray(mask)
        per = [self._scene_levels(coords[b], mask[b])
               for b in range(coords.shape[0])]
        return tuple(lv for lv, _ in per), all(hit for _, hit in per)

    def _labels(self, levels, coords: torch.Tensor, mask: torch.Tensor,
                feats: torch.Tensor) -> torch.Tensor:
        """(cap,) int32 class ids of one padded scene on the device: the
        forward over its pyramid, then argmax."""
        pc = M.PointCloud(coords, mask, 1)
        logits = MU.minkunet_apply(self.module, pc,
                                   feats.to(torch.float32), flow=self.flow,
                                   levels=levels)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def replica(self, device) -> "PointCloudEngine":
        """This engine on another device for scene-parallel serving: a
        copy of the weights there, the same session and flow.  Its
        `_apply_batch` takes operands on that device."""
        import copy
        dev = torch.device(device)
        rep = copy.copy(self)
        rep.device = dev
        rep.module = copy.deepcopy(self.module).to(dev)
        return rep

    def _apply_batch(self, levels_b, coords_b: torch.Tensor,
                     mask_b: torch.Tensor,
                     feats_b: torch.Tensor) -> torch.Tensor:
        """(B, cap) int32 class ids of a micro-batch: each scene through
        `_labels`, one after another.  A dummy scene (levels None, fully
        masked) is skipped; its row stays -1."""
        self._shapes["apply_batch"].add(tuple(coords_b.shape[:2]))
        out = torch.full(tuple(coords_b.shape[:2]), -1, dtype=torch.int32,
                         device=coords_b.device)
        for i, levels in enumerate(levels_b):
            if levels is not None:
                out[i] = self._labels(levels, coords_b[i], mask_b[i],
                                      feats_b[i])
        return out

    # -- serving entry points ---------------------------------------------

    def segment(self, coords, mask, feats, levels=None, partition=None):
        """One scene -> (per-point class ids on the engine's device,
        mapping_cache_hit).  Pass `levels` (from `levels_for`) to skip the
        cache lookup; the hit flag is then None.

        `partition` opens the city-scale path: True / "auto" (the default
        policy) or a `repro_torch.partition.PartitionPolicy`.  A scene too
        big for the ladder, which the plain path rejects, is then
        octree-chunked over its packed keys with exact receptive-field
        halos, each chunk served through the engine's scheduler as an
        ordinary scene, and the labels stitched back into the caller's row
        order (halo rows dropped; rows outside every chunk, i.e. masked
        rows, come back as -1).  A policy with `force=True` partitions a
        scene that fits too.  The hit flag is True only when every chunk's
        pyramid came from the mapping cache.
        """
        n = np.asarray(coords).shape[0]
        if partition is not None:
            from repro_torch.partition import PartitionPolicy
            policy = PartitionPolicy() if partition in (True, "auto") \
                else partition
            if policy.force or not self.ladder.fits(n):
                return self._segment_partitioned(coords, mask, feats,
                                                 policy)
        cap = self.ladder.bucket_for(n)
        c, m, f = BK.pad_scene(coords, mask, feats, cap)
        hit = None
        if levels is None:
            levels, hit = self._levels_padded(c, m, cap)
        self._shapes["apply"].add(c.shape)
        preds = self._labels(levels, torch.from_numpy(c).to(self.device),
                             torch.from_numpy(m).to(self.device),
                             torch.from_numpy(f).to(self.device))
        return preds[:n], hit

    def _segment_partitioned(self, coords, mask, feats, policy):
        """Chunk-stream one scene through the scheduler and stitch (see
        `segment(partition=)`).  The plan's telemetry lands in
        `self.last_partition_stats`."""
        from repro_torch.partition import plan_partition
        plan = plan_partition(coords, mask, feats,
                              spec=MU.halo_spec(self.module),
                              ladder=self.ladder, policy=policy)
        tracer = self.obs.tracer if self.obs is not None else None
        tid = None
        if tracer is not None:
            self._n_partitions += 1
            tid = f"partition:{self._n_partitions}"
            tracer.begin(tid, name="partition", n_chunks=plan.n_chunks,
                         n_rows=int(plan.n_rows))
        preds, hit, errors = plan.run(self.scheduler(), tracer, tid)
        if tracer is not None:
            tracer.end(tid, outcome="ok" if not errors else "chunk_errors",
                       n_errors=len(errors))
        self.last_partition_stats = plan.stats()
        self.last_partition_stats["chunk_errors"] = len(errors)
        if errors:
            detail = "; ".join(f"chunk {i}: {err}"
                               for i, err in sorted(errors.items()))
            raise RuntimeError(
                f"segment(partition=): {len(errors)}/{plan.n_chunks} "
                f"chunks failed — {detail}")
        return torch.from_numpy(preds).to(self.device), hit

    def segment_batch(self, coords, mask, feats, on_error: str = "raise",
                      priority: int = 0):
        """(B, N, 1+D) scenes -> ((B, N) int32 class ids on the host,
        mapping_cache_hit).

        Served through the internal `ServeScheduler`: each scene is
        admitted, micro-batched with its bucket peers and executed, and
        results are reassembled in submission order.  The hit flag is True
        only when every scene's pyramid came from the mapping cache.

        Per-scene failures (the scheduler's typed `ServeResult.error`:
        rejected / shed / timeout / exec_failed) surface by `on_error`:

          * "raise" (default) — raise `RuntimeError` naming every failed
            scene index and its error;
          * "partial" — return `(preds, hit, errors)` where `errors` is
            {scene_index: ServeError} and failed scenes' rows are -1.

        The scheduler is shared (`self.scheduler()`): scenes another
        caller queued are flushed along with this batch, but their results
        stay drainable — only this call's requests are taken.  `priority`
        is forwarded to every scene's `submit`.
        """
        if on_error not in ("raise", "partial"):
            raise ValueError(f"on_error must be 'raise' or 'partial', "
                             f"got {on_error!r}")
        coords = np.asarray(coords)
        mask = np.asarray(mask)
        feats = np.asarray(feats)
        # stacked scenes share N: one ladder check up front, so an
        # overflow raises before any scene is admitted
        self.ladder.bucket_for(coords.shape[1])
        sched = self.scheduler()
        rids = [sched.submit(coords[b], feats[b], mask[b],
                             priority=priority)
                for b in range(coords.shape[0])]
        sched.flush()
        by_rid = sched.take(rids)
        errors = {b: by_rid[rid].error for b, rid in enumerate(rids)
                  if by_rid[rid].error is not None}
        if errors and on_error == "raise":
            detail = "; ".join(f"scene {b}: {err}"
                               for b, err in sorted(errors.items()))
            raise RuntimeError(
                f"segment_batch: {len(errors)}/{len(rids)} scenes "
                f"failed — {detail}")
        n = coords.shape[1]
        preds = np.stack([
            by_rid[rid].preds if b not in errors
            else np.full(n, -1, np.int32)
            for b, rid in enumerate(rids)])
        hit = all(by_rid[rid].mapping_hit for b, rid in enumerate(rids)
                  if b not in errors)
        if on_error == "partial":
            return torch.from_numpy(preds), hit, errors
        return torch.from_numpy(preds), hit

    # -- telemetry --------------------------------------------------------

    def cache_stats(self) -> dict:
        return self.session.cache_stats()

    def compile_stats(self) -> dict:
        """How many distinct shapes each entry point has run (the
        reference counts its compiled programs): bounded by the ladder
        buckets seen."""
        return {name: len(shapes) for name, shapes in self._shapes.items()}
