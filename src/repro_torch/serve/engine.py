"""Point-cloud serving engine: MinkUNet segmentation behind a bucket ladder
and a digest-keyed mapping cache.

  * `segment(coords, mask, feats)` — one scene: padded to its ladder
    bucket, level pyramid served from the mapping cache (keyed by the
    padded coordinates), forward, argmax, predictions sliced back to the
    caller's row count.
  * `levels_for(coords, mask)` — the cached mapping pass alone.

The default flow is `"cuda_fused"`, so `segment` runs the hand-written
fused sparse-conv kernel on every conv (the reference's default is
`"fod"`).  Where the reference jits and vmaps its entry points, these are
eager calls.  Batched serving (`segment_batch`, the scheduler) and
city-scale partitioning are not ported yet: they raise and name the
ROADMAP item that brings them.
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

_BATCHED = ("batched serving (segment_batch, the ServeScheduler, "
            "compile_stats) is not ported yet; see ROADMAP.md Queue A.7-A.8")
_PARTITION = ("city-scale partitioning (segment(partition=...)) is not "
              "ported yet; see ROADMAP.md Queue A.9")


class PointCloudEngine:
    """Serving frontend for MinkUNet-style sparse segmentation models.

    `params_or_module` is a `models.minkunet.MinkUNet` or a parameter tree
    (nested dicts/lists of tensors).  The weights move to `device`: None
    resolves to the first CUDA device and raises when there is none;
    `device="cpu"` opts into the plain PyTorch versions of the kernels.
    """

    def __init__(self, params_or_module, n_stages: int,
                 flow: str = "cuda_fused", device=None,
                 engine: Optional[str] = None, cache_entries: int = 32,
                 ladder: Optional[BK.BucketLadder] = None):
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

    @classmethod
    def factory(cls, params_or_module, n_stages: int, **kwargs):
        """Zero-arg engine factory for pool owners: each call builds an
        engine with its own caches over the same weights and config."""

        def build() -> "PointCloudEngine":
            return cls(params_or_module, n_stages, **kwargs)

        return build

    def scheduler(self):
        raise NotImplementedError(_BATCHED)

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

        def build():
            pc = M.PointCloud(torch.from_numpy(coords).to(self.device),
                              torch.from_numpy(mask).to(self.device), 1)
            return MU.build_unet_maps(pc, self.n_stages, engine=self.engine)

        return self.session.maps_cache.get_by_key(key, build)

    def levels_for(self, coords, mask, batched: bool = False):
        """(level pyramid, cache_hit) for one geometry, built at the
        scene's bucket capacity (as `segment` pads it)."""
        if batched:
            raise NotImplementedError(_BATCHED)
        cap = self.ladder.bucket_for(np.asarray(coords).shape[0])
        c, m, _ = BK.pad_scene(coords, mask, None, cap)
        return self._levels_padded(c, m, cap)

    # -- serving entry points ---------------------------------------------

    def segment(self, coords, mask, feats, levels=None, partition=None):
        """One scene -> (per-point class ids on the engine's device,
        mapping_cache_hit).  Pass `levels` (from `levels_for`) to skip the
        cache lookup; the hit flag is then None."""
        if partition is not None:
            raise NotImplementedError(_PARTITION)
        n = np.asarray(coords).shape[0]
        cap = self.ladder.bucket_for(n)
        c, m, f = BK.pad_scene(coords, mask, feats, cap)
        hit = None
        if levels is None:
            levels, hit = self._levels_padded(c, m, cap)
        pc = M.PointCloud(torch.from_numpy(c).to(self.device),
                          torch.from_numpy(m).to(self.device), 1)
        feats_t = torch.from_numpy(np.ascontiguousarray(f, np.float32))
        logits = MU.minkunet_apply(self.module, pc, feats_t.to(self.device),
                                   flow=self.flow, levels=levels)
        return torch.argmax(logits, dim=-1)[:n].to(torch.int32), hit

    def segment_batch(self, *args, **kwargs):
        raise NotImplementedError(_BATCHED)

    # -- telemetry --------------------------------------------------------

    def cache_stats(self) -> dict:
        return self.session.cache_stats()

    def compile_stats(self) -> dict:
        raise NotImplementedError(_BATCHED)
