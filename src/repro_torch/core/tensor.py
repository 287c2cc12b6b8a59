"""SparseTensor + MapContext: features with their geometry and its cached
Mapping-Unit state.

  * `SparseTensor` — features + a masked voxel cloud + tensor stride,
    sharing one `MapContext` along a network.
  * `MapContext` — everything the mapping produces for one geometry: the
    cloud per stride level (a `SortedCloud` under the v2 engine) and every
    kernel map keyed by (kernel_size, in_stride, out_stride).  The same
    key finds the forward maps that a transposed conv swaps.

Mapping state is built lazily and memoized.  Under v2 the first conv at a
stride level sorts the cloud once and every later conv there is binary
searches; under v1 (clouds that are not 3-D, or coordinates outside the
packed-key budget) each map is its own lexicographic sort.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import fusion as FU
from repro_torch.core import mapping as M


def geometry_digest(arrays, extra=None) -> bytes:
    """16-byte blake2b identity of a geometry: each array's (shape, dtype)
    tag + raw bytes, with `extra` static metadata (bucket capacity, entry
    tag) folded in.  Byte-identical to the reference's digest for the same
    numpy arrays; tensors are hashed as their numpy copies."""
    h = hashlib.blake2b(digest_size=16)
    if extra is not None:
        h.update(repr(extra).encode())
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        h.update(str((a.shape, a.dtype)).encode())
        h.update(a.tobytes())
    return h.digest()


def infer_kernel_size(k: int, ndim: int) -> int:
    """Weights are (K, Cin, Cout) with K = kernel_size**ndim."""
    ks = round(k ** (1.0 / ndim))
    for cand in (ks - 1, ks, ks + 1):
        if cand >= 1 and cand ** ndim == k:
            return cand
    raise ValueError(
        f"cannot infer kernel_size: {k} weight offsets is not a perfect "
        f"{ndim}-th power; pass kernel_size explicitly")


class MapContext:
    """Mapping state for one geometry:

    clouds : stride -> SortedCloud (v2, sorted on first demand) or
             PointCloud (v1)
    maps   : (kernel_size, in_stride, out_stride) -> KernelMaps
    plans  : conv-site shape -> core.fusion.ConvFusionPlan (`plan`)

    `engine` None is inferred from the first cloud registered: "v2" for a
    3-D cloud, else "v1".
    """

    def __init__(self, engine: str | None = None, cap: int | None = None):
        if engine not in (None, "v1", "v2"):
            raise ValueError(f"unknown mapping engine {engine!r}")
        self.engine = engine
        self.cap = cap
        self.clouds: dict[int, M.PointCloud | M.SortedCloud] = {}
        self.maps: dict[tuple[int, int, int], M.KernelMaps] = {}
        self.plans: dict[tuple, FU.ConvFusionPlan] = {}

    def register_cloud(self, stride: int, cloud, overwrite: bool = False):
        """Install a cloud at a stride level (no-op if one is present)."""
        pc = cloud.pc if isinstance(cloud, M.SortedCloud) else cloud
        if self.engine is None:
            self.engine = "v2" if pc.ndim_spatial == 3 else "v1"
        if overwrite or stride not in self.clouds:
            self.clouds[stride] = cloud

    def point_cloud(self, stride: int) -> M.PointCloud:
        entry = self.clouds[stride]
        return entry.pc if isinstance(entry, M.SortedCloud) else entry

    def sorted_cloud(self, stride: int) -> M.SortedCloud:
        """The stride level's ranking cache; sorts once on first demand."""
        entry = self.clouds[stride]
        if not isinstance(entry, M.SortedCloud):
            entry = M.sort_cloud(entry)
            self.clouds[stride] = entry
        return entry

    def down_cloud(self, in_stride: int, factor: int) -> M.PointCloud:
        """Output cloud of a strided conv (memoized per stride level)."""
        target = in_stride * factor
        if target not in self.clouds:
            if self.engine == "v2":
                self.clouds[target] = M.downsample_sorted(
                    self.sorted_cloud(in_stride), factor)
            else:
                self.clouds[target] = M.downsample(
                    self.point_cloud(in_stride), factor)
        return self.point_cloud(target)

    def conv_maps(self, kernel_size: int, in_stride: int,
                  factor: int = 1) -> tuple[M.KernelMaps, M.PointCloud]:
        """Maps + output cloud for a (possibly strided) conv, memoized.
        v2: binary searches against the level's SortedCloud; strided maps
        also carry the swapped inverse table (`inv_t`).  v1: one batched
        lexicographic intersection over the offsets."""
        out_stride = in_stride * factor
        key = (kernel_size, in_stride, out_stride)
        if key not in self.maps:
            if self.engine == "v2":
                sc = self.sorted_cloud(in_stride)
                if factor == 1:
                    out_sc = sc
                else:
                    self.down_cloud(in_stride, factor)
                    out_sc = self.sorted_cloud(out_stride)
                self.maps[key], _ = M.build_conv_maps_cached(
                    sc, kernel_size, factor, cap=self.cap, out_sc=out_sc)
            else:
                in_pc = self.point_cloud(in_stride)
                out_pc = in_pc if factor == 1 else \
                    self.down_cloud(in_stride, factor)
                self.maps[key] = M.kernel_map(in_pc, out_pc, kernel_size,
                                              cap=self.cap)
        return self.maps[key], self.point_cloud(out_stride)

    def transposed_maps(self, kernel_size: int, coarse_stride: int,
                        factor: int) -> tuple[M.KernelMaps, M.PointCloud]:
        """Swapped maps for an up-conv from `coarse_stride` back to the
        finer level; the forward strided conv must have run first."""
        if factor < 1 or coarse_stride % factor:
            raise ValueError(
                f"transposed stride {factor} does not divide the input "
                f"stride {coarse_stride}")
        fine_stride = coarse_stride // factor
        key = (kernel_size, fine_stride, coarse_stride)
        if key not in self.maps:
            built = sorted(self.maps) or "none"
            raise ValueError(
                f"no forward maps for stride pair {fine_stride}->"
                f"{coarse_stride} at kernel_size {kernel_size}: a "
                f"transposed conv reuses the encoder's strided maps "
                f"swapped, so the forward conv must run through this "
                f"context first (maps built so far: {built})")
        return self.maps[key].swap(), self.point_cloud(fine_stride)

    def plan(self, n_in: int, cin: int, cout: int, k: int, *,
             residual: bool = False,
             budget_bytes: int | None = None) -> FU.ConvFusionPlan:
        """Memoized `core.fusion.plan_conv_epilogue` for one conv site."""
        budget = budget_bytes or FU.DEFAULT_ONCHIP_BUDGET_BYTES
        key = (n_in, cin, cout, k, residual, budget)
        if key not in self.plans:
            self.plans[key] = FU.plan_conv_epilogue(
                n_in, cin, cout, k, residual=residual, budget_bytes=budget)
        return self.plans[key]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """Features + masked voxel cloud + tensor stride + shared MapContext.
    Invalid rows carry the coordinate sentinel and zero features."""

    feats: torch.Tensor         # (N, C)
    coords: torch.Tensor        # (N, 1+D) int32, sentinel-filled
    mask: torch.Tensor          # (N,) bool
    stride: int = 1
    context: MapContext = dataclasses.field(default_factory=MapContext,
                                            repr=False, compare=False)

    @property
    def pc(self) -> M.PointCloud:
        return M.PointCloud(self.coords, self.mask, self.stride)

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim_spatial(self) -> int:
        return self.coords.shape[1] - 1

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def num_valid(self) -> torch.Tensor:
        return self.mask.sum()

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        """Same geometry (and context), new features."""
        return dataclasses.replace(self, feats=feats)

    def padded_to(self, capacity: int) -> "SparseTensor":
        """Row-pad up to a serving-bucket capacity with sentinel rows; the
        padded tensor starts a fresh MapContext with the same engine and
        cap (maps are capacity-shaped)."""
        if capacity < self.capacity:
            raise ValueError(
                f"cannot pad a capacity-{self.capacity} tensor down to "
                f"{capacity}; buckets only grow")
        if capacity == self.capacity:
            return self
        pad = capacity - self.capacity
        dev = self.coords.device
        coords = torch.cat([self.coords, torch.full(
            (pad, self.coords.shape[1]), M.SENTINEL, dtype=torch.int32,
            device=dev)])
        mask = torch.cat([self.mask, torch.zeros(pad, dtype=torch.bool,
                                                 device=dev)])
        feats = torch.cat([self.feats, self.feats.new_zeros(
            (pad,) + tuple(self.feats.shape[1:]))])
        ctx = MapContext(engine=self.context.engine, cap=self.context.cap)
        ctx.register_cloud(self.stride, M.PointCloud(coords, mask,
                                                     self.stride))
        return SparseTensor(feats, coords, mask, self.stride, ctx)



def from_point_cloud(pc: M.PointCloud, feats: torch.Tensor,
                     context: MapContext | None = None) -> SparseTensor:
    """Wrap an existing PointCloud (already sentinel-filled) + features."""
    ctx = context if context is not None else MapContext()
    ctx.register_cloud(pc.stride, pc)
    return SparseTensor(feats, pc.coords, pc.mask, pc.stride, ctx)
