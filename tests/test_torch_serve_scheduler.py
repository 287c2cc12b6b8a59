"""Port of the continuous-batching serve scheduler, on the CPU at
mini-MinkUNet size: the bucket ladder, the `ServeScheduler` (queueing,
bucketed micro-batches, out-of-order drain, telemetry), bounded shape
counts through every engine entry point, the AssemblyCache (hit /
permute / evict), dummy fill, the in-flight FIFO, concurrent producers,
deadline flushes, per-bucket widths, the chaos stream, and
`PointCloudEngine.segment_batch` / `levels_for(batched=True)`.  Mirrors
tests/test_serve_scheduler.py (its sharded-mesh cases wait for the port of
`distributed/`); predictions are held against `segment` of the same
weights and ladder, the code each scheduled scene runs.

The last tests run one mixed stream through the reference's
`ServeScheduler(mesh=None, pipeline_depth=0)` (flow "fod", its weights
loaded into the port) and the port's: labels equal on valid rows, and the
stats() key sets and every count (submitted, completed, batches, dummies,
mapping and assembly hits / misses / evictions, faults) equal; timing
fields are left out."""

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.api import MappingCache
from repro_torch.core import mapping as M
from repro_torch.data.synthetic import lidar_scene
from repro_torch.kernels.spconv import spconv as TK
from repro_torch.obs import metrics as TMX
from repro_torch.serve.buckets import (BucketLadder, geometric_ladder,
                                       max_batch_from_occupancy, pad_scene)
from repro_torch.serve.engine import PointCloudEngine
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.scheduler import ServeScheduler
from tests.test_torch_serve_faults import (  # noqa: F401 (a fixture)
    mini_engine, mini_module, one_torch_thread, seg_preds)


def _scene_cf(seed, n):
    c, m, f = lidar_scene(seed=40 + seed, n_points=n, grid=16)
    return c, f, m


# ---------------------------------------------------------------------------
# bucket ladder policy
# ---------------------------------------------------------------------------

def test_bucket_ladder_selection_validation_and_padding_bound():
    ladder = BucketLadder((64, 128, 256))
    assert ladder.n_buckets == 3
    assert [ladder.bucket_for(n) for n in (1, 64, 65, 256)] == \
        [64, 64, 128, 256]
    assert ladder.index_for(200) == 2
    assert ladder.fits(256) and not ladder.fits(257)
    with pytest.raises(ValueError, match="exceeds the bucket ladder"):
        ladder.bucket_for(257)
    assert ladder.padding_fraction(96) == pytest.approx(0.25)
    for bad, match in (((128, 64), "ascending"), ((64, 64), "ascending"),
                       ((0, 64), "positive")):
        with pytest.raises(ValueError, match=match):
            BucketLadder(bad)
    with pytest.raises(ValueError, match="growth"):
        geometric_ladder(64, 256, growth=1.0)
    caps = geometric_ladder(128, 4096, growth=2.0).capacities
    assert caps[0] == 128 and caps[-1] >= 4096
    assert all(c % 8 == 0 for c in caps)
    for n in range(129, 4096, 97):
        assert geometric_ladder(128, 4096).padding_fraction(n) < 0.5 + 1e-9


def test_pad_scene_sentinels_and_masked_rows():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 10, size=(5, 4)).astype(np.int32)
    mask = np.array([True, True, False, True, True])
    feats = rng.normal(size=(5, 3)).astype(np.float32)
    c, m, f = pad_scene(coords, mask, feats, 8)
    assert c.shape == (8, 4) and m.shape == (8,) and f.shape == (8, 3)
    np.testing.assert_array_equal(m, list(mask) + [False] * 3)
    assert (c[5:] == M.SENTINEL).all() and (c[2] == M.SENTINEL).all()
    assert (f[5:] == 0).all() and (f[2] == 0).all()
    np.testing.assert_array_equal(c[0], coords[0])
    with pytest.raises(ValueError, match="pad.*down"):
        pad_scene(coords, mask, feats, 4)
    c2, _, f2 = pad_scene(coords, mask, None, 8)
    np.testing.assert_array_equal(c2, c)
    assert f2 is None


def test_mapping_cache_extra_distinguishes_buckets():
    cache = MappingCache()
    a = np.zeros(4, np.int32)
    assert cache.get((a,), lambda: "b128", extra=("levels", 128)) \
        == ("b128", False)
    assert cache.get((a,), lambda: "b256", extra=("levels", 256)) \
        == ("b256", False)
    assert cache.get((a,), lambda: None, extra=("levels", 128)) \
        == ("b128", True)
    assert MappingCache.digest((a,)) != MappingCache.digest((a,), "tag")
    assert "hit_rate" in cache.stats()


# ---------------------------------------------------------------------------
# heterogeneous stream through the scheduler
# ---------------------------------------------------------------------------

def test_scheduler_heterogeneous_stream_acceptance():
    """16 scenes of 4 sizes: shape counts bounded by the buckets, labels
    equal to `segment`, out-of-order drain, padding / occupancy / hit-rate
    telemetry, and no kernel launch on the CPU."""
    engine = mini_engine(64, 512)
    sched = ServeScheduler(engine, max_batch=4)
    sizes = [40, 90, 150, 300]
    scenes = [lidar_scene(seed=20 + i % 8, n_points=sizes[i % 4], grid=24)
              for i in range(16)]
    TK.reset_launch_counts()
    rids = [sched.submit(c, f, m) for (c, m, f) in scenes]
    sched.flush()
    results = sched.drain()
    assert len(results) == 16 and sched.drain() == []
    assert not any(TK.LAUNCHES.values())
    drained_order = [r.rid for r in results]
    assert sorted(drained_order) == sorted(rids)
    assert drained_order != sorted(drained_order)
    by_rid = {r.rid: r for r in results}
    for rid, (c, m, f) in zip(rids, scenes):
        r = by_rid[rid]
        assert r.n_points == c.shape[0] and r.preds.dtype == np.int32
        np.testing.assert_array_equal(r.preds,
                                      seg_preds(c, m, f, ladder=(64, 512)))
    n_buckets_used = len({r.bucket for r in results})
    assert n_buckets_used == 4
    comp = engine.compile_stats()
    assert 0 < comp["build"] <= n_buckets_used
    assert 0 < comp["apply_batch"] <= n_buckets_used
    assert comp["apply"] == 0
    stats = sched.stats()
    assert stats["compiles"] == {"build": comp["build"],
                                 "apply_batch": comp["apply_batch"]}
    assert stats["n_completed"] == 16 and stats["queue_depth"] == 0
    assert stats["mapping_cache"]["hits"] == 8
    assert stats["mapping_cache"]["hit_rate"] == pytest.approx(0.5)
    assert stats["padding_overhead"] > 0
    assert stats["n_devices"] == 1
    for b in stats["buckets"].values():
        assert 0 < b["occupancy"] <= 1.0 and b["scenes"] == 4
    assert all(by_rid[rid].mapping_hit for rid in rids[8:])
    assert not any(by_rid[rid].mapping_hit for rid in rids[:8])


def test_scheduler_full_bucket_partial_flush_and_serve():
    """A full bucket runs on submit; a straggler runs at flush with dummy
    fill (counted in occupancy, not in the mapping cache); `serve` returns
    this call's rids; an oversized scene is a typed `rejected` result."""
    engine = mini_engine(64, 128)
    sched = ServeScheduler(engine, max_batch=2)
    sched.submit(*_scene_cf(0, 40))
    assert len(sched.drain()) == 0
    sched.submit(*_scene_cf(1, 40))                   # fills the bucket
    assert [r.rid for r in sched.drain()] == [0, 1]

    one = ServeScheduler(mini_engine(64, 64), max_batch=4)
    c, f, m = _scene_cf(0, 50)
    rid = one.submit(c, f, m)
    assert one.flush() == 1
    (res,) = one.drain()
    assert res.rid == rid
    np.testing.assert_array_equal(res.preds, seg_preds(c, m, f))
    stats = one.stats()
    assert stats["buckets"][64]["dummy_scenes"] == 3
    assert stats["buckets"][64]["occupancy"] == pytest.approx(0.25)
    assert stats["mapping_cache"]["misses"] == 1

    out = sched.serve([_scene_cf(i, n) for i, n in enumerate((30, 80))])
    assert set(out) == {2, 3}
    rid = sched.submit(*_scene_cf(9, 400))
    res = sched.take([rid])[rid]
    assert not res.ok and res.preds is None
    assert res.error.code == "rejected"
    assert "exceeds the bucket ladder" in res.error.message
    st = sched.stats()
    assert st["n_submitted"] == 5 and st["faults"]["rejected"] == 1
    with pytest.raises(ValueError, match="max_batch"):
        ServeScheduler(engine, max_batch=0)


@pytest.mark.parametrize("flow", ["fod", "cuda", "cuda_fused"])
def test_scheduler_flows_mixed_buckets(flow):
    """Every port flow through the scheduler under mixed buckets equals
    that flow's `segment`, and the labels equal the `fod` flow's."""
    ladder = geometric_ladder(48, 96)
    engine = PointCloudEngine(mini_module(), 2, device="cpu", flow=flow,
                              ladder=ladder)
    ref = PointCloudEngine(mini_module(), 2, device="cpu", flow=flow,
                           ladder=ladder)
    fod = PointCloudEngine(mini_module(), 2, device="cpu", flow="fod",
                           ladder=ladder)
    sched = ServeScheduler(engine, max_batch=2)
    scenes = [_scene_cf(i, n) for i, n in enumerate([30, 70, 40, 90])]
    rids = [sched.submit(c, f, m) for (c, f, m) in scenes]
    sched.flush()
    by_rid = {r.rid: r for r in sched.drain()}
    assert sorted(by_rid) == rids
    for rid, (c, f, m) in zip(rids, scenes):
        np.testing.assert_array_equal(by_rid[rid].preds,
                                      ref.segment(c, m, f)[0].numpy())
        np.testing.assert_array_equal(by_rid[rid].preds[m],
                                      fod.segment(c, m, f)[0].numpy()[m])
    assert engine.compile_stats()["apply_batch"] <= 2


# ---------------------------------------------------------------------------
# engine entry points
# ---------------------------------------------------------------------------

def test_engine_segment_bounded_shapes_across_sizes():
    engine = mini_engine(128, 256)
    refs = {}
    for n in (50, 80, 100, 128):                  # all -> bucket 128
        c, m, f = lidar_scene(seed=60 + n, n_points=n, grid=20)
        preds, hit = engine.segment(c, m, f)
        assert not hit and preds.shape == (n,)
        refs[n] = (preds.numpy(), c, m, f)
    comp = engine.compile_stats()
    assert comp["build"] == 1 and comp["apply"] == 1
    c, m, f = lidar_scene(seed=61, n_points=200, grid=20)
    engine.segment(c, m, f)
    comp = engine.compile_stats()
    assert comp["build"] == 2 and comp["apply"] == 2
    assert comp["apply_batch"] == 0
    c, m, f = refs[80][1:]
    levels, hit = engine.levels_for(c, m)
    assert hit
    preds, hit2 = engine.segment(c, m, f, levels=levels)
    assert hit2 is None
    np.testing.assert_array_equal(preds.numpy(), refs[80][0])
    assert engine.compile_stats()["apply"] == 2


def test_segment_batch_shares_scheduler_without_stealing_results():
    engine = mini_engine(64, 64, max_batch=2)
    sched = engine.scheduler()
    assert engine.scheduler() is sched and sched.max_batch == 2
    c, f, m = _scene_cf(0, 40)
    rid = sched.submit(c, f, m)
    scenes = [_scene_cf(i, 40) for i in (1, 2)]
    preds, hit = engine.segment_batch(np.stack([s[0] for s in scenes]),
                                      np.stack([s[2] for s in scenes]),
                                      np.stack([s[1] for s in scenes]))
    assert preds.shape == (2, 40) and hit is False
    for b, (sc, sf, sm) in enumerate(scenes):
        np.testing.assert_array_equal(preds[b].numpy(),
                                      seg_preds(sc, sm, sf, ladder=(64, 64)))
    res = sched.drain()
    assert [r.rid for r in res] == [rid]
    np.testing.assert_array_equal(res[0].preds,
                                  seg_preds(c, m, f, ladder=(64, 64)))


def test_segment_batch_ladder_overflow_leaves_no_orphans():
    engine = mini_engine(64, 128)
    scenes = [_scene_cf(i, 160) for i in range(2)]
    coords = np.stack([c for c, _, _ in scenes])
    feats = np.stack([f for _, f, _ in scenes])
    mask = np.stack([m for _, _, m in scenes])
    with pytest.raises(ValueError, match="exceeds the bucket ladder"):
        engine.segment_batch(coords, mask, feats)
    stats = engine.scheduler().stats()
    assert stats["n_submitted"] == 0 and stats["queue_depth"] == 0


def test_padding_telemetry_counts_valid_rows():
    engine = mini_engine(64, 64)
    sched = ServeScheduler(engine, max_batch=1)
    c, m, f = lidar_scene(seed=80, n_points=64, grid=12)
    assert not m.all()
    rid = sched.submit(c, f, m)
    res = sched.take([rid])[rid]
    assert res.padding_frac == pytest.approx(1.0 - m.sum() / 64)
    assert sched.stats()["padding_overhead"] == pytest.approx(
        64 / m.sum() - 1.0)


def test_engine_batched_levels_cache_per_scene():
    engine = mini_engine(128, 128)
    scenes = [lidar_scene(seed=70 + i, n_points=100, grid=20)
              for i in range(3)]
    coords = np.stack([c for c, _, _ in scenes])
    mask = np.stack([m for _, m, _ in scenes])
    levels, hit = engine.levels_for(coords, mask, batched=True)
    assert not hit and isinstance(levels, tuple) and len(levels) == 3
    rev, hit = engine.levels_for(coords[::-1], mask[::-1], batched=True)
    assert hit and rev[0] is levels[2]
    assert engine.cache_stats()["hits"] == 3


def test_mesh_other_than_auto_is_not_ported():
    """mesh=None and mesh="auto" on a host without two cards serve on the
    engine's device: no scene mesh, one device, max_batch as given."""
    engine = mini_engine()
    assert ServeScheduler(engine, mesh=None).stats()["n_devices"] == 1
    sched = ServeScheduler(engine, max_batch=3)
    assert sched.mesh is None and sched.max_batch == 3
    assert sched.stats()["n_devices"] == 1


def test_scene_sharded_scheduler_matches_per_scene_loop():
    """A scene mesh over two devices (here both the CPU): max_batch is
    rounded up to the device count, each micro-batch's scenes split
    over the devices through `shard_over_scenes`, and the labels equal
    `segment` of each scene alone."""
    from repro_torch.distributed.sharding import make_scene_mesh
    engine = mini_engine(64, 128)
    mesh = make_scene_mesh(devices=["cpu", "cpu"])
    sched = ServeScheduler(engine, max_batch=3, mesh=mesh)
    assert sched.mesh is mesh and sched.max_batch == 4
    scenes = [_scene_cf(5 + i, n) for i, n in enumerate([40, 90, 60, 120,
                                                         50, 100])]
    rids = [sched.submit(c, f, m) for (c, f, m) in scenes]
    sched.flush()
    by_rid = {r.rid: r for r in sched.drain()}
    assert sorted(by_rid) == rids
    for rid, (c, f, m) in zip(rids, scenes):
        np.testing.assert_array_equal(by_rid[rid].preds, seg_preds(c, m, f))
    stats = sched.stats()
    assert stats["n_devices"] == 2 and stats["n_completed"] == 6
    assert len(stats["buckets"]) == 2


# ---------------------------------------------------------------------------
# pipelined hot loop: assembly cache, dummy fill, async dispatch, threads
# ---------------------------------------------------------------------------

def test_assembly_cache_repeated_vs_permuted_composition():
    engine = mini_engine(64, 64)
    sched = ServeScheduler(engine, max_batch=2)
    a, b = _scene_cf(0, 40), _scene_cf(1, 50)
    r1 = sched.take([sched.submit(c, f, m) for (c, f, m) in (a, b)])
    ac = sched.stats()["assembly_cache"]
    assert (ac["hits"], ac["misses"]) == (0, 1)
    mc0 = engine.cache_stats()
    r2 = sched.take([sched.submit(c, f, m) for (c, f, m) in (a, b)])
    ac = sched.stats()["assembly_cache"]
    assert (ac["hits"], ac["misses"]) == (1, 1)
    mc = engine.cache_stats()           # mapping cache never consulted
    assert mc["hits"] == mc0["hits"] and mc["misses"] == mc0["misses"]
    assert all(r.mapping_hit for r in r2.values())
    r3 = sched.take([sched.submit(c, f, m) for (c, f, m) in (b, a)])
    ac = sched.stats()["assembly_cache"]
    assert (ac["hits"], ac["misses"]) == (1, 2)
    assert engine.cache_stats()["hits"] == mc0["hits"] + 2
    for res, order in ((r1, (a, b)), (r2, (a, b)), (r3, (b, a))):
        for rid, (c, f, m) in zip(sorted(res), order):
            np.testing.assert_array_equal(
                res[rid].preds, seg_preds(c, m, f, ladder=(64, 64)))
    assert engine.compile_stats()["apply_batch"] == 1


def test_assembly_cache_lru_eviction_bound():
    engine = mini_engine(64, 64)
    sched = ServeScheduler(engine, max_batch=1, assembly_cache_entries=1)
    a, b = _scene_cf(0, 40), _scene_cf(1, 50)
    for (c, f, m) in (a, b, a):         # a evicted by b, then b by a
        sched.take([sched.submit(c, f, m)])
    ac = sched.stats()["assembly_cache"]
    assert ac == {"hits": 0, "misses": 3, "hit_rate": 0.0,
                  "evictions": 2, "entries": 1, "max_entries": 1}
    with pytest.raises(ValueError, match="max_entries"):
        ServeScheduler(engine, assembly_cache_entries=-1)


def test_dummy_fill_skipped_and_straggler_composition_hits():
    """Partial micro-batches carry no pyramid for their dummy scenes (the
    engine skips them: their rows come back -1); a replayed straggler
    composition (same scene, same tail length) hits the assembly cache."""
    engine = mini_engine(64, 64)
    sched = ServeScheduler(engine, max_batch=4)
    a, b = _scene_cf(0, 40), _scene_cf(1, 50)
    rid = sched.submit(*a)
    sched.flush()                       # 1 real + 3 dummies
    sched.submit(*a), sched.submit(*b)
    sched.flush()                       # 2 real + 2 dummies
    sched.submit(*a)
    sched.flush()                       # same straggler composition
    st = sched.stats()
    assert st["assembly_cache"]["hits"] == 1
    assert st["buckets"][64]["dummy_scenes"] == 3 + 2 + 3
    assert st["mapping_cache"]["misses"] == 2
    res = {r.rid: r for r in sched.drain()}
    (c, f, m) = a
    np.testing.assert_array_equal(res[rid].preds,
                                  seg_preds(c, m, f, ladder=(64, 64)))
    levels, _ = engine.levels_for(c, m)
    pc, pm, pf = pad_scene(c, m, f, 64)
    out = engine._apply_batch(
        (levels, None), torch.from_numpy(np.stack([pc, pc])),
        torch.from_numpy(np.stack([pm, np.zeros_like(pm)])),
        torch.from_numpy(np.stack([pf, pf])))
    assert out.dtype == torch.int32 and (out[1] == -1).all()
    np.testing.assert_array_equal(out[0, :40].numpy(), res[rid].preds)


def test_async_dispatch_parks_in_flight_fifo_retirement():
    engine = mini_engine(64, 128)
    sched = ServeScheduler(engine, max_batch=2, pipeline_depth=2)
    for n in (40, 40, 90, 90):          # fills bucket 64, then bucket 128
        sched.submit(*_scene_cf(n, n))
    st = sched.stats()
    assert st["in_flight"] == 2 and st["n_completed"] == 0
    assert [r.rid for r in sched.drain()] == [0, 1, 2, 3]
    assert sched.stats()["in_flight"] == 0
    sched2 = ServeScheduler(engine, max_batch=1, pipeline_depth=1)
    for i in range(3):
        sched2.submit(*_scene_cf(i, 40))
    st = sched2.stats()
    assert st["in_flight"] == 1 and st["n_completed"] == 2
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServeScheduler(engine, pipeline_depth=-1)


def test_thread_safe_submit_under_concurrent_producers():
    """More producer threads than cores, with a short switch interval:
    no rid is lost or repeated and the counters add up."""
    engine = mini_engine(64, 128)
    sched = ServeScheduler(engine, max_batch=4)
    submitted = []
    n_threads = max(8, 2 * (os.cpu_count() or 1))

    def producer(t):
        for j in range(2):
            c, f, m = _scene_cf(2 * t + j, 40 if j % 2 else 90)
            submitted.append((sched.submit(c, f, m), (c, f, m)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    sched.flush()
    results = {r.rid: r for r in sched.drain()}
    n = 2 * n_threads
    assert sorted(rid for rid, _ in submitted) == list(range(n))
    st = sched.stats()
    assert st["n_submitted"] == n and st["n_completed"] == n
    assert st["queue_depth"] == 0 and st["in_flight"] == 0
    for rid, (c, f, m) in submitted:
        np.testing.assert_array_equal(results[rid].preds,
                                      seg_preds(c, m, f))


def test_feature_off_is_bit_identical():
    """pipeline_depth=0 with assembly_cache_entries=0 (synchronous, no
    assembly cache) serves the same repeated stream bit-identically to
    the defaults (assembly cache, in-flight slots)."""
    def run(**kw):
        engine = mini_engine(48, 96)
        sched = ServeScheduler(engine, max_batch=2, **kw)
        base = [_scene_cf(i, n) for i, n in enumerate((30, 70, 40, 90))]
        return sched, sched.serve(base * 2)

    sync_sched, sync_out = run(pipeline_depth=0, assembly_cache_entries=0)
    pipe_sched, pipe_out = run()
    assert sync_sched.stats()["assembly_cache"] is None
    assert pipe_sched.stats()["assembly_cache"]["hits"] >= 2
    assert sorted(sync_out) == sorted(pipe_out)
    for rid in sync_out:
        np.testing.assert_array_equal(sync_out[rid].preds,
                                      pipe_out[rid].preds)
    a, b = sync_sched.stats(), pipe_sched.stats()
    for key in ("n_ok", "buckets", "padding_overhead"):
        assert a[key] == b[key], key
    assert a["mapping_cache"]["misses"] == b["mapping_cache"]["misses"]


def test_serve_returns_only_own_requests():
    engine = mini_engine(64, 64)
    sched = ServeScheduler(engine, max_batch=4)
    c, f, m = _scene_cf(0, 40)
    foreign = sched.submit(c, f, m)
    out = sched.serve([_scene_cf(i, 40) for i in (1, 2)])
    assert set(out) == {1, 2}
    res = sched.drain()
    assert [r.rid for r in res] == [foreign]
    np.testing.assert_array_equal(res[0].preds,
                                  seg_preds(c, m, f, ladder=(64, 64)))


def test_deadline_flush_runs_overdue_partial_batch():
    engine = mini_engine(64, 64)
    sched = ServeScheduler(engine, max_batch=4, max_wait_s=0.05,
                           watchdog_s=0)
    c, f, m = _scene_cf(0, 40)
    rid = sched.submit(c, f, m)
    assert sched.stats()["deadline_flushes"] == 0
    assert sched.stats()["queue_depth"] == 1
    time.sleep(0.06)
    results = sched.poll()                      # deadline fires here
    assert sched.stats()["deadline_flushes"] == 1
    res = {r.rid: r for r in results + sched.drain()}
    np.testing.assert_array_equal(res[rid].preds,
                                  seg_preds(c, m, f, ladder=(64, 64)))
    assert sched.stats()["buckets"][64]["dummy_scenes"] == 3


def test_per_bucket_max_batch_overrides_and_ladder_config():
    engine = mini_engine(64, 128)
    sched = ServeScheduler(engine, max_batch={64: 2, "default": 4})
    assert sched.max_batch_for(64) == 2 and sched.max_batch_for(128) == 4
    sched.submit(*_scene_cf(0, 40))
    sched.submit(*_scene_cf(1, 40))             # width-2 bucket dispatches
    assert len(sched.drain()) == 2
    st = sched.stats()["buckets"][64]
    assert st["batches"] == 1 and st["dummy_scenes"] == 0
    assert st["max_batch"] == 2
    with pytest.raises(ValueError, match="not on the ladder"):
        ServeScheduler(engine, max_batch={999: 2})
    engine2 = PointCloudEngine(mini_module(), 2, device="cpu",
                               ladder=BucketLadder((64, 128),
                                                   max_batch=(1, 2)))
    sched2 = ServeScheduler(engine2)
    assert sched2.max_batch_for(64) == 1 and sched2.max_batch_for(128) == 2
    with pytest.raises(ValueError, match="one positive width"):
        BucketLadder((64, 128), max_batch=(2,))
    assert max_batch_from_occupancy(
        {64: {"scenes": 2, "batches": 2}, 128: {"scenes": 7, "batches": 2},
         256: {"scenes": 0, "batches": 0}}, default=4) == \
        {64: 1, 128: 4, 256: 4}


def test_chaos_concurrent_producers_with_injected_faults():
    """Concurrent producers through an injected FaultPlan (one transient
    dispatch failure, one NaN-corrupted scene, one oversized scene): every
    rid resolves to labels or a typed error, the survivors equal
    `segment`, and a clean follow-up stream serves."""
    engine = mini_engine(64, 128)
    plan = FaultPlan(fail_dispatches={0}, corrupt_scenes={5})
    sched = ServeScheduler(engine, max_batch=2, fault_plan=plan)
    submitted = []

    def producer(t):
        for j in range(4):
            scene = _scene_cf(4 * t + j, 40 if j % 2 else 90)
            submitted.append((sched.submit(*scene), scene))

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    big_rid = sched.submit(*_scene_cf(99, 400))
    submitted.append((big_rid, None))
    sched.flush()
    results = {r.rid: r for r in sched.drain()}
    assert sorted(results) == sorted(rid for rid, _ in submitted)
    errors = {rid: r.error for rid, r in results.items()
              if r.error is not None}
    assert results[big_rid].error.code == "rejected"
    assert len(errors) == 2
    assert all(e.code == "rejected" for e in errors.values())
    n_ok = 0
    for rid, scene in submitted:
        if rid in errors:
            continue
        c, f, m = scene
        np.testing.assert_array_equal(results[rid].preds,
                                      seg_preds(c, m, f))
        n_ok += 1
    assert n_ok == 11
    st = sched.stats()
    assert st["n_submitted"] == 13 and st["n_completed"] == 13
    assert st["faults"]["rejected"] == 2
    assert st["faults"]["exec_failed"] == 0
    assert st["faults"]["failed_dispatches"] == 1
    assert st["faults"]["retries"] >= 1
    assert st["faults"]["recovery_s"] is not None
    assert plan.stats()["failures_injected"] == 1
    assert plan.stats()["scenes_corrupted"] == 1
    follow = [_scene_cf(200 + i, 40) for i in range(2)]
    out = sched.serve(follow)
    assert len(out) == 2
    for rid, (c, f, m) in zip(sorted(out), follow):
        assert out[rid].ok
        np.testing.assert_array_equal(out[rid].preds, seg_preds(c, m, f))


# ---------------------------------------------------------------------------
# parity with the reference scheduler
# ---------------------------------------------------------------------------

# a mixed stream over three buckets with repeats (mapping and assembly
# hits), stragglers (dummy fill) and, with max_batch 2 and an assembly
# cache of 2 entries, evictions
STREAM = [(0, 40), (1, 90), (2, 40), (3, 150), (0, 40), (2, 40),
          (4, 90), (1, 90), (5, 200), (0, 40), (2, 40), (6, 60),
          (3, 150), (7, 90)]
LADDER = (64, 256)


def _stream():
    return [lidar_scene(seed=500 + s, n_points=n, grid=16) for s, n in STREAM]


@pytest.fixture(scope="module")
def reference():
    from repro.models import minkunet as MU
    from repro.serve.buckets import geometric_ladder as ref_ladder
    from repro.serve.engine import PointCloudEngine as RefEngine

    params = jax.jit(lambda k: MU.mini_minkunet_init(
        k, c_in=4, n_classes=2))(jax.random.key(0))
    module = _port_module(params)
    engine = RefEngine(params, n_stages=2, flow="fod",
                       ladder=ref_ladder(*LADDER), max_batch=2, mesh=None)
    return engine, module


def _port_module(params):
    from repro_torch.models import minkunet as TMU
    return TMU.load_jax_params(
        TMU.mini_minkunet_init(torch.Generator().manual_seed(0), c_in=4,
                               n_classes=2),
        jax.tree_util.tree_map(np.asarray, params))


def _fresh(ref_engine):
    """The shared reference engine with an empty mapping cache and no
    scheduler (its compiled programs are kept)."""
    from repro.api import MappingCache as RefCache

    ref_engine.session.maps_cache = RefCache(32)
    ref_engine._scheduler = None
    return ref_engine


def _serve(sched, scenes):
    rids = [sched.submit(c, f, m) for c, m, f in scenes]
    sched.flush()
    out = sched.take(rids)
    return [out[r] for r in rids], sched.stats()


def _counts(st):
    """Every count of stats() that does not depend on timing."""
    return {
        "keys": (set(st), set(st["faults"]),
                 [set(b) for b in st["buckets"].values()]),
        "n": (st["n_submitted"], st["n_completed"], st["n_ok"],
              st["queue_depth"], st["in_flight"], st["deadline_flushes"]),
        "buckets": st["buckets"],
        "padding_overhead": st["padding_overhead"],
        "mapping": {k: st["mapping_cache"][k]
                    for k in ("hits", "misses", "evictions", "entries")},
        "assembly": None if st["assembly_cache"] is None else
        {k: st["assembly_cache"][k]
         for k in ("hits", "misses", "evictions", "entries")},
        "faults": {k: v for k, v in st["faults"].items()
                   if k not in ("retry_backoff_s", "recovery_s")},
        "widths": (st["max_batch"], st["max_batch_overrides"],
                   st["scheduler_max_backlog"]),
    }


def _assert_same(got, want, scenes):
    for r, w, (c, m, f) in zip(got, want, scenes):
        assert r.rid == w.rid and r.ok == w.ok and r.bucket == w.bucket
        assert r.mapping_hit == w.mapping_hit
        assert r.padding_frac == w.padding_frac
        if w.ok:
            np.testing.assert_array_equal(r.preds[m], np.asarray(w.preds)[m])
        else:
            assert (r.error.code, r.error.detail) == (w.error.code,
                                                      w.error.detail)


@pytest.mark.parametrize("port_depth,flow", [(0, "fod"), (2, "cuda_fused")])
def test_scheduler_stream_matches_reference(reference, port_depth, flow):
    """The same stream through the reference scheduler (synchronous) and
    the port's, synchronous and pipelined: labels equal on valid rows,
    the stats() key sets and every count equal."""
    from repro.obs import metrics as MX
    from repro.serve.scheduler import ServeScheduler as RefScheduler

    ref_engine, module = reference
    scenes = _stream()
    want, want_st = _serve(RefScheduler(
        _fresh(ref_engine), max_batch=2, mesh=None, pipeline_depth=0,
        assembly_cache_entries=2), scenes)
    port = PointCloudEngine(module, 2, device="cpu", flow=flow,
                            ladder=geometric_ladder(*LADDER))
    got, got_st = _serve(ServeScheduler(
        port, max_batch=2, pipeline_depth=port_depth,
        assembly_cache_entries=2), scenes)
    _assert_same(got, want, scenes)
    assert TMX.SCHEDULER_STATS_KEYS == MX.SCHEDULER_STATS_KEYS
    assert TMX.SCHEDULER_BUCKET_KEYS == MX.SCHEDULER_BUCKET_KEYS
    assert TMX.SCHEDULER_FAULT_KEYS == MX.SCHEDULER_FAULT_KEYS
    want_c, got_c = _counts(want_st), _counts(got_st)
    assert got_c == want_c
    assert want_c["assembly"]["hits"] > 0
    assert want_c["assembly"]["evictions"] > 0
    assert want_c["mapping"]["hits"] > 0
    assert sum(b["dummy_scenes"] for b in want_st["buckets"].values()) > 0
    assert got_st["compiles"] == {"build": 3, "apply_batch": 3}


def test_scheduler_faults_match_reference(reference):
    """One transient dispatch failure (retried, bisected), a poisoned
    scene (exec_failed after its retries), a corrupted and an oversized
    scene (rejected): the same typed results and fault counts."""
    from repro.serve.faults import FaultPlan as RefPlan
    from repro.serve.scheduler import ServeScheduler as RefScheduler

    ref_engine, module = reference
    scenes = _stream()[:8] + [lidar_scene(seed=600, n_points=400, grid=16)]
    kw = dict(fail_dispatches={1}, poison_rids={6}, corrupt_scenes={3})
    want, want_st = _serve(RefScheduler(
        _fresh(ref_engine), max_batch=2, mesh=None, pipeline_depth=0,
        fault_plan=RefPlan(**kw)), scenes)
    port = PointCloudEngine(module, 2, device="cpu",
                            ladder=geometric_ladder(*LADDER))
    got, got_st = _serve(ServeScheduler(port, max_batch=2,
                                        fault_plan=FaultPlan(**kw)), scenes)
    _assert_same(got, want, scenes)
    want_c, got_c = _counts(want_st), _counts(got_st)
    assert got_c == want_c
    assert want_c["faults"]["exec_failed"] == 1
    assert want_c["faults"]["rejected"] == 2
    assert want_c["faults"]["failed_dispatches"] >= 2


def test_segment_batch_and_batched_levels_match_reference(reference):
    ref_engine, module = reference
    _fresh(ref_engine)
    scenes = [lidar_scene(seed=700 + i, n_points=90, grid=16)
              for i in range(3)]
    coords = np.stack([c for c, _, _ in scenes])
    mask = np.stack([m for _, m, _ in scenes])
    feats = np.stack([f for _, _, f in scenes])
    port = PointCloudEngine(module, 2, device="cpu", max_batch=2,
                            ladder=geometric_ladder(*LADDER))
    want, want_hit = ref_engine.segment_batch(coords, mask, feats)
    got, got_hit = port.segment_batch(coords, mask, feats)
    assert got.dtype == torch.int32 and got.shape == want.shape
    want = np.asarray(want)
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy()[mask[b]],
                                      want[b][mask[b]])
    assert got_hit == want_hit
    # both engines now hold every scene: a reversed batch hits throughout
    _, ref_hit = ref_engine.levels_for(coords[::-1], mask[::-1],
                                       batched=True)
    levels, hit = port.levels_for(coords[::-1], mask[::-1], batched=True)
    assert hit is ref_hit is True and len(levels) == 3
    assert port.cache_stats()["hits"] == 3
    comp = port.compile_stats()
    assert set(comp) == set(ref_engine.compile_stats())
    assert comp == {"build": 1, "apply": 0, "apply_batch": 1}
