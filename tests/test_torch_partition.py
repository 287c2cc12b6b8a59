"""Port of city-scale partitioning (`repro_torch.partition`), on the CPU:
the host packed-key helpers bit for bit against the reference's, octree
range splitting over the 62-bit keys, exact receptive-field halos, the
plan against the reference's plan on the same scene, chunk-streamed serving
through the scheduler, and the halo-exactness acceptance — chunked labels
equal the monolithic labels on every valid row for the flows `fod`, `cuda`
and `cuda_fused` (on the CPU the kernel flows take their plain versions),
and the reference's `fod` labels of the same weights.  Mirrors
tests/test_partition.py and tests/test_obs.py's partition trace; the
border behaviour of the port's mapping ops (`downsample_sorted` /
`kernel_map_v2` at chunk boundaries) is pinned at the map level.  The
reference runs only where parity needs it: its planner on the same
scene, and its `fod` forward under `jax.jit`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as RM
from repro.core import packed as RPK
from repro.models import minkunet as RMU
from repro.partition import PartitionPolicy as RPolicy
from repro.partition import plan_partition as r_plan_partition
from repro.partition.halo import build_pyramid as r_build_pyramid
from repro.serve.buckets import geometric_ladder as r_geometric_ladder
from repro_torch.core import mapping as M
from repro_torch.core import packed as PK
from repro_torch.data.synthetic import city_scene, lidar_scene
from repro_torch.models import minkunet as MU
from repro_torch.obs import Observability
from repro_torch.partition import (HaloSpec, PartitionPolicy, plan_partition,
                                   split_ranges)
from repro_torch.partition.halo import build_pyramid
from repro_torch.partition.octree import rank_keys
from repro_torch.serve import faults as FLT
from repro_torch.serve.buckets import DEFAULT_LADDER, geometric_ladder
from repro_torch.serve.engine import PointCloudEngine
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.jit(functools.partial(RMU.mini_minkunet_init, c_in=4,
                                     n_classes=2))(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _module():
    """The port's mini-MinkUNet carrying the reference's weights."""
    return MU.load_jax_params(
        MU.mini_minkunet_init(torch.Generator().manual_seed(0), c_in=4,
                              n_classes=2),
        jax.tree_util.tree_map(np.asarray, _ref_params()))


@jax.jit
def _ref_labels_jit(params, coords, mask, feats):
    pc = RM.make_point_cloud(coords, mask)
    return jnp.argmax(RMU.minkunet_apply(params, pc, feats, flow="fod"), -1)


def _ref_preds(coords, mask, feats):
    """The reference's `fod` labels of the whole scene (same weights)."""
    return np.asarray(_ref_labels_jit(_ref_params(), jnp.asarray(coords),
                                      jnp.asarray(mask), jnp.asarray(feats)))


def _engine(flow="fod", lo=128, hi=512, **kw):
    return PointCloudEngine(_module(), 2, flow=flow, device="cpu",
                            ladder=geometric_ladder(lo, hi), **kw)


def _rand_coords(rng, n, dup_frac=0.3):
    """Random in-budget coords, with deliberate duplicates (multi-row
    sites)."""
    coords = np.concatenate(
        [rng.integers(0, PK.BATCH_MAX + 1, size=(n, 1)),
         rng.integers(PK.COORD_MIN, PK.COORD_MAX + 1, size=(n, 3))],
        axis=1).astype(np.int64)
    n_dup = int(n * dup_frac)
    coords[:n_dup] = coords[rng.integers(n_dup, n, size=n_dup)]
    return coords


def _rand_sorted_keys(rng, n, dup_frac=0.3):
    return np.sort(PK.pack_coords_host(_rand_coords(rng, n, dup_frac)))


# ---------------------------------------------------------------------------
# host key helpers: bit for bit against the reference's
# ---------------------------------------------------------------------------

def test_key64_constants_match_reference_and_device_sentinel():
    assert PK.KEY64_BITS == RPK.KEY64_BITS == 62
    assert PK.KEY64_SENTINEL.dtype == np.uint64
    assert PK.KEY64_SENTINEL == RPK.KEY64_SENTINEL
    assert int(PK.KEY64_SENTINEL) == PK.KEY_SENTINEL == 2**63 - 1


def test_pack_and_unpack_key64_bit_equal_to_reference():
    """In-budget rows, out-of-budget rows (every field past each end) and
    masked rows: the same uint64 keys; unpacking gives the same coords."""
    rng = np.random.default_rng(3)
    good = _rand_coords(rng, 300)
    bad = np.array([[-1, 0, 0, 0], [PK.BATCH_MAX + 1, 0, 0, 0],
                    [0, PK.COORD_MIN - 1, 0, 0], [0, 0, PK.COORD_MAX + 1, 0],
                    [0, 0, 0, PK.COORD_MIN - 1], [0, PK.COORD_MAX, 0, 0],
                    [PK.BATCH_MAX, PK.COORD_MIN, PK.COORD_MAX, 0]], np.int64)
    coords = np.concatenate([good, bad]).astype(np.int32)
    mask = rng.random(coords.shape[0]) > 0.2
    for m in (None, mask):
        got = PK.pack_coords_host(coords, m)
        want = RPK.pack_coords_host(coords, m)
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(PK.unpack_key64(got),
                                      RPK.unpack_key64(want))
    keys = PK.pack_coords_host(coords)
    assert (keys[len(good):len(good) + 5] == PK.KEY64_SENTINEL).all()
    assert (PK.unpack_key64(keys)[len(good):len(good) + 5]
            == PK.COORD_SENTINEL).all()
    np.testing.assert_array_equal(PK.unpack_key64(keys)[:len(good)], good)


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_quantize_key64_bit_equal_to_reference(stride):
    rng = np.random.default_rng(stride)
    keys = PK.pack_coords_host(_rand_coords(rng, 400),
                               rng.random(400) > 0.1)
    got = PK.quantize_key64(keys, stride)
    np.testing.assert_array_equal(got, RPK.quantize_key64(keys, stride))
    assert (got[keys == PK.KEY64_SENTINEL] == PK.KEY64_SENTINEL).all()
    # the key-domain quantization is the coordinate-domain one
    c = PK.unpack_key64(keys[keys != PK.KEY64_SENTINEL]).astype(np.int64)
    c[:, 1:] = np.floor_divide(c[:, 1:], stride) * stride
    np.testing.assert_array_equal(got[keys != PK.KEY64_SENTINEL],
                                  PK.pack_coords_host(c))
    with pytest.raises(ValueError, match="power of two"):
        PK.quantize_key64(keys, 3)


def test_compose_key64_bit_equal_to_reference_and_to_device_keys():
    rng = np.random.default_rng(9)
    coords = _rand_coords(rng, 200).astype(np.int32)
    hi, lo = RPK.pack_coords(jnp.asarray(coords))
    got = PK.compose_key64(np.asarray(hi), np.asarray(lo))
    np.testing.assert_array_equal(
        got, RPK.compose_key64(np.asarray(hi), np.asarray(lo)))
    np.testing.assert_array_equal(got, PK.pack_coords_host(coords))
    dev = PK.pack_coords(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, dev.astype(np.uint64))


# ---------------------------------------------------------------------------
# octree range splitting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1, 7, 64, 10_000])
def test_split_ranges_invariants(budget):
    """Coverage, ordering, budget bound, and the no-split-equal-keys
    guarantee, on keys with duplicate sites; the same ranges as the
    reference's."""
    from repro.partition import split_ranges as r_split_ranges
    rng = np.random.default_rng(5)
    keys = _rand_sorted_keys(rng, 400)
    ranges = split_ranges(keys, budget)
    assert ranges == r_split_ranges(keys, budget)
    assert ranges[0][0] == 0 and ranges[-1][1] == keys.shape[0]
    for (s, e), (s2, _) in zip(ranges, ranges[1:]):
        assert s < e and e == s2
    for s, e in ranges:
        if e - s > budget:
            assert (keys[s:e] == keys[s]).all()
        if s > 0:
            assert keys[s - 1] != keys[s]


def test_split_ranges_equal_keys_stay_together():
    keys = np.full(17, 12345, np.uint64)
    assert split_ranges(keys, 1) == [(0, 17)]
    assert split_ranges(np.empty(0, np.uint64), 4) == []
    with pytest.raises(ValueError, match="budget"):
        split_ranges(keys, 0)


def test_rank_keys_orders_valid_rows_first():
    coords, mask, _ = lidar_scene(seed=2, n_points=120, grid=16)
    keys, order, n_valid = rank_keys(coords, mask)
    assert n_valid == int(mask.sum())
    assert (np.diff(keys.astype(np.uint64)) >= 0).all()
    assert (keys[:n_valid] < PK.KEY64_SENTINEL).all()
    assert (keys[n_valid:] == PK.KEY64_SENTINEL).all()
    assert mask[order[:n_valid]].all() and not mask[order[n_valid:]].any()
    np.testing.assert_array_equal(
        keys[:n_valid], PK.pack_coords_host(coords[order[:n_valid]]))


# ---------------------------------------------------------------------------
# plan: ownership, halo accounting, parity with the reference's plan
# ---------------------------------------------------------------------------

def test_every_valid_point_is_interior_to_exactly_one_chunk():
    coords, mask, feats = city_scene(seed=4, n_points=1500)
    ladder = geometric_ladder(128, 2048)
    plan = plan_partition(coords, mask, feats,
                          spec=HaloSpec.uniform(2, 1), ladder=ladder,
                          policy=PartitionPolicy(chunk_budget=256,
                                                 force=True))
    assert plan.n_chunks > 1
    owned = np.concatenate([c.rows[c.interior] for c in plan.chunks])
    assert owned.shape[0] == int(mask.sum())
    assert np.unique(owned).shape[0] == owned.shape[0]
    assert set(owned) == set(np.flatnonzero(mask))
    for c in plan.chunks:
        assert c.mask.all() and c.n_points <= ladder.capacities[-1]
        np.testing.assert_array_equal(c.coords, coords[c.rows])
        np.testing.assert_array_equal(c.feats, feats[c.rows])
    assert 0.0 <= plan.halo_fraction < 1.0
    assert plan.stats()["halo_rows"] == sum(c.n_halo for c in plan.chunks)


@pytest.mark.parametrize("budget", [256, None])
def test_plan_equals_reference_plan(budget):
    """The port's planner against the reference's on the same scene: the
    same budget, the same chunks in the same order, each with equal rows,
    interior marks, coords and feats."""
    coords, mask, feats = city_scene(seed=4, n_points=1500)
    spec = HaloSpec.uniform(2, 1)
    got = plan_partition(coords, mask, feats, spec=spec,
                         ladder=geometric_ladder(128, 2048),
                         policy=PartitionPolicy(chunk_budget=budget,
                                                force=True))
    from repro.partition import HaloSpec as RHaloSpec
    want = r_plan_partition(coords, mask, feats,
                            spec=RHaloSpec.uniform(2, 1),
                            ladder=r_geometric_ladder(128, 2048),
                            policy=RPolicy(chunk_budget=budget, force=True))
    assert got.n_chunks == want.n_chunks > 1
    assert (got.budget, got.n_rows, got.n_valid) == \
        (want.budget, want.n_rows, want.n_valid)
    assert got.stats() == want.stats()
    for a, b in zip(got.chunks, want.chunks):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.interior, b.interior)
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.feats, b.feats)
        assert a.rows.dtype == b.rows.dtype


def test_stitch_marks_failed_chunks_and_invalid_rows():
    coords, mask, feats = lidar_scene(seed=6, n_points=200, grid=16)
    plan = plan_partition(coords, mask, feats,
                          spec=HaloSpec.uniform(2, 1),
                          ladder=geometric_ladder(64, 512),
                          policy=PartitionPolicy(chunk_budget=48,
                                                 force=True))
    assert plan.n_chunks >= 2
    preds = [np.full(c.n_points, 7, np.int32) for c in plan.chunks]
    preds[0] = None                                   # a failed chunk
    out = plan.stitch(preds)
    assert out.dtype == np.int32
    dead = plan.chunks[0].rows[plan.chunks[0].interior]
    assert (out[dead] == -1).all()
    assert (out[~mask] == -1).all()
    alive = np.concatenate([c.rows[c.interior] for c in plan.chunks[1:]])
    assert (out[alive] == 7).all()


def test_policy_validation_and_unpartitionable_scene():
    coords, mask, feats = lidar_scene(seed=8, n_points=600, grid=12)
    spec = HaloSpec.uniform(2, 1)
    with pytest.raises(ValueError, match="chunk_budget"):
        plan_partition(coords, mask, feats, spec=spec,
                       ladder=geometric_ladder(64, 128),
                       policy=PartitionPolicy(chunk_budget=4096))
    with pytest.raises(ValueError, match="halo outgrows the ladder"):
        plan_partition(coords, mask, feats, spec=spec,
                       ladder=geometric_ladder(64, 128),
                       policy=PartitionPolicy(chunk_budget=64, force=True))
    with pytest.raises(ValueError, match=r"\(N, 4\) coords"):
        plan_partition(coords[:, :3], mask, feats, spec=spec,
                       ladder=geometric_ladder(64, 128))


def test_halo_spec_from_module_and_tree():
    spec = MU.halo_spec(_module())
    assert spec == MU.halo_spec(_module().tree()) == HaloSpec.uniform(2, 1)
    assert spec == RMU.halo_spec(_ref_params())
    assert spec.dec_rounds == (2, 2) and spec.enc_rounds == (1, 2, 2)
    # full width (the smoke's model): the spec alone, no forward
    full = MU.minkunet_init(torch.Generator().manual_seed(0))
    assert MU.halo_spec(full) == HaloSpec.uniform(4, 2)
    assert MU.halo_spec(full).enc_rounds == (1, 4, 4, 4, 4)


# ---------------------------------------------------------------------------
# the port's mapping ops at chunk borders (downsample_sorted / kernel_map_v2)
# ---------------------------------------------------------------------------

def _cloud(coords):
    mask = np.ones(coords.shape[0], bool)
    return M.make_point_cloud(torch.from_numpy(coords),
                              torch.from_numpy(mask))


def _subm_neighbor_sets(coords, k=3):
    pc = _cloud(coords)
    inv = M.kernel_map_v2(M.sort_cloud(pc), pc, k).inv.numpy()
    cn = pc.coords.numpy()
    return {tuple(cn[j]): frozenset(tuple(cn[inv[o, j]])
                                    for o in range(inv.shape[0])
                                    if inv[o, j] >= 0)
            for j in range(coords.shape[0])}


def _down_member_sets(coords):
    pc = _cloud(coords)
    sc0 = M.sort_cloud(pc)
    sc1 = M.downsample_sorted(sc0)
    inv = M.kernel_map_v2(sc0, sc1.pc, 2).inv.numpy()
    c0 = pc.coords.numpy()
    c1, m1 = sc1.pc.coords.numpy(), sc1.pc.mask.numpy()
    return {tuple(c1[j]): frozenset(tuple(c0[inv[o, j]])
                                    for o in range(inv.shape[0])
                                    if inv[o, j] >= 0)
            for j in range(c1.shape[0]) if m1[j]}


def test_chunk_border_maps_match_monolithic_on_interior():
    """A straddling-stride split: collinear points along z cut mid
    cell-pair.  On interior sites both the k=3 submanifold map and the
    stride-2 downsample map of the halo'd chunk cloud must match the
    monolithic cloud's exactly."""
    n = 16
    coords = np.zeros((n, 4), np.int32)
    coords[:, 3] = np.arange(n)
    mask = np.ones(n, bool)
    feats = np.zeros((n, 4), np.float32)
    plan = plan_partition(coords, mask, feats,
                          spec=HaloSpec.uniform(1, 1),
                          ladder=geometric_ladder(8, 64),
                          policy=PartitionPolicy(chunk_budget=2,
                                                 force=True))
    assert plan.n_chunks == n // 2
    interiors = sorted(tuple(sorted(c.coords[c.interior][:, 3]))
                       for c in plan.chunks)
    assert interiors == [(2 * k, 2 * k + 1) for k in range(n // 2)]

    mono_subm = _subm_neighbor_sets(coords)
    mono_down = _down_member_sets(coords)
    for chunk in plan.chunks:
        sub = _subm_neighbor_sets(chunk.coords)
        down = _down_member_sets(chunk.coords)
        for p in map(tuple, chunk.coords[chunk.interior]):
            assert sub[p] == mono_subm[p]
        cells = {tuple(q) for q in PK.unpack_key64(PK.quantize_key64(
            PK.pack_coords_host(chunk.coords[chunk.interior]), 2))}
        for cell in cells:
            assert down[cell] == mono_down[cell]


def test_build_pyramid_matches_downsample_sorted_and_reference():
    """The host key pyramid = the port's device `downsample_sorted`
    pyramid, level by level, and the reference's host pyramid."""
    coords, mask, _ = lidar_scene(seed=9, n_points=300, grid=16)
    keys, _, n_valid = rank_keys(coords, mask)
    pyr = build_pyramid(np.unique(keys[:n_valid]), n_stages=2)
    ref = r_build_pyramid(np.unique(keys[:n_valid]), n_stages=2)
    sc = M.sort_cloud(M.make_point_cloud(torch.from_numpy(coords),
                                         torch.from_numpy(mask)))
    for level in range(3):
        np.testing.assert_array_equal(pyr.levels[level], ref.levels[level])
        cn = sc.pc.coords.numpy()[sc.pc.mask.numpy()]
        np.testing.assert_array_equal(
            pyr.levels[level], np.sort(PK.pack_coords_host(cn)))
        if level < 2:
            sc = M.downsample_sorted(sc)


# ---------------------------------------------------------------------------
# acceptance: chunked == monolithic (== reference), oversized completes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flow", ["fod", "cuda", "cuda_fused"])
def test_forced_partition_matches_monolithic(flow):
    """Halo exactness end to end: a scene that fits the ladder, served
    whole and force-chunked, gives equal class ids on every valid row (and
    -1 on masked rows), for the three flows, equal to the reference's
    `fod` labels too."""
    engine = _engine(flow)
    coords, mask, feats = lidar_scene(seed=12, n_points=400, grid=16)
    mono, _ = engine.segment(coords, mask, feats)
    part, _ = engine.segment(
        coords, mask, feats,
        partition=PartitionPolicy(chunk_budget=96, force=True))
    assert part.dtype == torch.int32 and part.device.type == "cpu"
    assert part.shape == (400,)
    part = part.numpy()
    assert engine.last_partition_stats["n_chunks"] > 1
    assert engine.last_partition_stats["chunk_errors"] == 0
    np.testing.assert_array_equal(part[mask], mono.numpy()[mask])
    assert (part[~mask] == -1).all()
    np.testing.assert_array_equal(part[mask],
                                  _ref_preds(coords, mask, feats)[mask])


def test_oversized_scene_completes_via_partition():
    """A scene above the ladder: segment() raises, the scheduler returns a
    typed `rejected` / `oversized` result naming the ladder max and the
    packed-key budget, and segment(partition="auto") completes with the
    reference's labels; a repeat hits the mapping cache in every chunk."""
    ladder = geometric_ladder(128, 512)
    engine = _engine(lo=128, hi=512)
    coords, mask, feats = city_scene(seed=15, n_points=1200, extent=140)

    with pytest.raises(ValueError, match="exceeds the bucket ladder"):
        engine.segment(coords, mask, feats)
    sched = engine.scheduler()
    res = sched.take([sched.submit(coords, feats, mask)]).popitem()[1]
    assert res.error is not None
    assert res.error.code == FLT.REJECTED
    assert res.error.detail == FLT.OVERSIZED
    assert str(ladder.capacities[-1]) in res.error.message
    assert "packed-key budget" in res.error.message
    assert "partition" in res.error.message
    bad = feats.copy()
    bad[mask.argmax()] = np.nan
    r2 = sched.take([sched.submit(coords, bad, mask)]).popitem()[1]
    assert r2.error.code == FLT.REJECTED
    assert r2.error.detail == FLT.MALFORMED

    preds, hit = engine.segment(coords, mask, feats, partition="auto")
    assert hit is False
    preds = preds.numpy()
    st = engine.last_partition_stats
    assert st["n_chunks"] > 1 and st["chunk_errors"] == 0
    assert st["max_chunk_points"] <= ladder.capacities[-1]
    np.testing.assert_array_equal(preds[mask],
                                  _ref_preds(coords, mask, feats)[mask])
    assert (preds[~mask] == -1).all()

    again, hit = engine.segment(coords, mask, feats, partition=True)
    assert hit is True
    np.testing.assert_array_equal(again.numpy(), preds)


def test_failed_chunk_raises_naming_it():
    """A chunk that completes with a typed error: segment(partition=)
    raises RuntimeError naming the failed chunk, and the stats count it."""
    from repro_torch.serve.faults import FaultPlan
    engine = _engine(max_batch=1, fault_plan=FaultPlan(fail_dispatches={0}))
    engine.scheduler().max_retries = 0
    coords, mask, feats = lidar_scene(seed=12, n_points=400, grid=16)
    with pytest.raises(RuntimeError, match=r"chunk 0: \[exec_failed\]"):
        engine.segment(coords, mask, feats,
                       partition=PartitionPolicy(chunk_budget=96, force=True))
    st = engine.last_partition_stats
    assert st["chunk_errors"] == 1 and st["n_chunks"] > 1


def test_partition_chunk_trace():
    """The partition trace: one `partition:<n>` root, a `chunk_fanout`
    span with every chunk's rid and a `stitch` span; each chunk rid is an
    ordinary closed request trace in the scheduler."""
    obs = Observability.enabled()
    engine = _engine(lo=64, hi=128, obs=obs)
    c, m, f = lidar_scene(seed=460, n_points=100, grid=16)
    preds, _ = engine.segment(
        c, m, f, partition=PartitionPolicy(chunk_budget=32, force=True))
    assert int((preds.numpy()[m] < 0).sum()) == 0
    part = [t for t in obs.tracer.finished()
            if t.tid.startswith("partition:")]
    assert len(part) == 1
    trace = part[0]
    assert trace.tid == "partition:1" and trace.closed
    assert trace.spans[trace.root_id].attrs["outcome"] == "ok"
    (fan,) = trace.find("chunk_fanout")
    (stitch,) = trace.find("stitch")
    n_chunks = engine.last_partition_stats["n_chunks"]
    assert fan.attrs["n_chunks"] == n_chunks
    assert len(fan.attrs["rids"]) == n_chunks
    assert stitch.attrs["n_errors"] == 0
    for rid in fan.attrs["rids"]:
        chunk = obs.tracer.get(f"scheduler:rid:{rid}")
        assert chunk is not None and chunk.closed


def test_default_density_city_scene_outgrows_the_full_width_ladder():
    """At the smoke's full width (4 stages, 2 blocks) and the default
    ladder, the budget halvings end with the halo still above the 65536
    top bucket for a default-density 100k-point city scene, as in the
    reference planner: the chip check's oversized scene is a quarter of
    that density."""
    spec = HaloSpec.uniform(4, 2)
    coords, mask, feats = city_scene(seed=20, n_points=100_000)
    with pytest.raises(ValueError, match="halo outgrows the ladder"):
        plan_partition(coords, mask, feats, spec=spec, ladder=DEFAULT_LADDER,
                       policy=PartitionPolicy(max_attempts=1))
