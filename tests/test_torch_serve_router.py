"""Port of the multi-worker serving fabric (`serve/router.py`), on the CPU
at mini-MinkUNet size: rendezvous digest affinity (scores equal to the
reference's), health-checked failover with in-flight replay, elastic pool
membership, graceful shedding, per-worker breakers under `overload=`, the
stats() schema and a failover trace, and the single-worker ==
bare-scheduler contract.  Mirrors tests/test_serve_router.py,
tests/test_obs.py's router cases and tests/test_serve_overload.py's router
wiring; predictions are held against the bare scheduler's over the same
weights and ladder.

Workers are `PointCloudEngine.factory(..., device="cpu")` engines (each
with its own mapping and assembly caches).  The last tests run one mixed
stream through the reference's `ServeRouter` (flow "fod", two workers) and
the port's over the same weights: the same worker for every scene, labels
equal on valid rows, and every count of stats() (pool, per worker, and
each worker's scheduler) equal; timing fields are left out.

The reference's failover-trace test keeps its victim in flight with
60000-point scenes whose device time outlasts the failover; on the CPU a
parked micro-batch is ready at once, so here the first worker's engine
carries `FaultPlan(delay_buckets=...)`: its wait for the victim outlasts a
tight liveness budget, the router declares it hung and replays the victim,
which has been dispatched once already, on the other worker."""

import copy
import hashlib
import time

import numpy as np
import pytest

from repro_torch.data.synthetic import lidar_scene
from repro_torch.kernels.spconv import spconv as TK
from repro_torch.launch.fault_tolerance import Pulse
from repro_torch.obs import Observability
from repro_torch.obs import metrics as MX
from repro_torch.serve import faults as FLT
from repro_torch.serve.buckets import geometric_ladder
from repro_torch.serve.engine import PointCloudEngine
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.overload import OverloadController
from repro_torch.serve.router import (LivenessPolicy, ServeRouter,
                                      _rendezvous_score)
from repro_torch.serve.scheduler import ServeScheduler
from tests.test_torch_serve_faults import (  # noqa: F401 (a fixture)
    mini_module, one_torch_thread)
from tests.test_torch_serve_scheduler import (  # noqa: F401 (a fixture)
    LADDER, _counts, _stream, reference)


def _scenes(n=10):
    out = []
    for s in range(n):
        c, m, f = lidar_scene(seed=240 + s, n_points=40 + 7 * s, grid=16)
        out.append((c, f, m))
    return out


SCENES = _scenes()


def _factory(**kw):
    kw.setdefault("ladder", geometric_ladder(64, 128))
    return PointCloudEngine.factory(mini_module(), 2, device="cpu",
                                    flow="fod", **kw)


@pytest.fixture(scope="module")
def bare():
    """The bare scheduler's predictions for SCENES in submission order:
    the bit-identity baseline."""
    sched = ServeScheduler(_factory()(), max_batch=2)
    out = sched.serve(SCENES)
    sched.close()
    return [out[r].preds for r in sorted(out)]


def _router(n_workers, factory=None, **kw):
    kw.setdefault("max_batch", 2)
    return ServeRouter(factory or _factory(), n_workers, **kw)


def _scene(seed, n):
    c, m, f = lidar_scene(seed=340 + seed, n_points=n, grid=16)
    return c, f, m


# ---------------------------------------------------------------------------
# pure units: policy + rendezvous hashing
# ---------------------------------------------------------------------------

def test_liveness_policy_validation():
    p = LivenessPolicy(beat_s=0.1, miss_beats=20)
    assert p.stall_s == pytest.approx(2.0)
    assert LivenessPolicy().stall_s == pytest.approx(30.0)
    with pytest.raises(ValueError, match="beat_s > 0"):
        LivenessPolicy(beat_s=0.0)
    with pytest.raises(ValueError, match="miss_beats"):
        LivenessPolicy(miss_beats=0)


def test_rendezvous_minimal_reshuffle():
    """Removing one worker moves ONLY the keys that ranked it first."""
    names3 = ["w0", "w1", "w2"]
    names2 = ["w0", "w1"]
    keys = [f"scene-{i}".encode() for i in range(200)]

    def best(key, names):
        return max(names, key=lambda n: _rendezvous_score(key, n))

    owners3 = {k: best(k, names3) for k in keys}
    owners2 = {k: best(k, names2) for k in keys}
    assert set(owners3.values()) == set(names3)
    for k in keys:
        if owners3[k] != "w2":
            assert owners2[k] == owners3[k]
    assert {k: best(k, names3) for k in keys} == owners3


def test_rendezvous_scores_equal_reference():
    """The same blake2b digest of (key, name) as the reference's: 100
    random keys x 4 names give equal scores, so both routers rank every
    geometry's workers alike."""
    from repro.serve.router import _rendezvous_score as ref_score
    rng = np.random.default_rng(0)
    names = ["w0", "w1", "w7", "edge-west"]
    for _ in range(100):
        key = rng.bytes(int(rng.integers(1, 64)))
        for name in names:
            got = _rendezvous_score(key, name)
            assert got == ref_score(key, name)
            want = hashlib.blake2b(
                key, digest_size=8, person=b"serve-rdzv",
                salt=hashlib.blake2b(name.encode(), digest_size=16).digest())
            assert got == int.from_bytes(want.digest(), "big")


def test_pulse_liveness():
    p = Pulse()
    assert p.age() < 0.5 and not p.stalled(0.5)
    time.sleep(0.06)
    assert p.stalled(0.05)
    p.beat()
    assert not p.stalled(0.05)


# ---------------------------------------------------------------------------
# routing + parity (no faults)
# ---------------------------------------------------------------------------

def test_single_worker_parity_with_bare_scheduler(bare):
    """The 1-worker router is bit-identical to the bare scheduler."""
    with _router(1) as r:
        out = r.serve(SCENES)
    assert len(out) == len(SCENES)
    for rid in sorted(out):
        res = out[rid]
        assert res.error is None
        np.testing.assert_array_equal(res.preds, bare[rid])
        assert res.n_points == np.asarray(SCENES[rid][0]).shape[0]


def test_digest_affinity_and_spread(bare):
    """Identical geometry keeps landing on the same worker (previewed and
    measured); distinct geometry spreads; the repeat hits the workers'
    caches.  (The reference's pool engines come warm from its fixture, so
    its repeat counts mapping hits; these engines are fresh.)"""
    with _router(3) as r:
        previews = [r.preview(c, m) for c, f, m in SCENES]
        assert all(p is not None for p in previews)
        assert len(set(previews)) > 1
        out1 = r.serve(SCENES)
        routed1 = {n: w["routed"] for n, w in r.stats()["workers"].items()}
        for name in routed1:
            assert routed1[name] == previews.count(name)
        out2 = r.serve(SCENES)
        st2 = r.stats()
        routed2 = {n: w["routed"] for n, w in st2["workers"].items()}
        assert routed2 == {n: 2 * c for n, c in routed1.items()}
        # affinity pays: the repeat builds no pyramid anew (each scene
        # missed once, on its own worker) and replays every micro-batch
        # composition from its worker's assembly cache
        pc = st2["pool_cache"]
        assert pc["mapping_misses"] == len(SCENES)
        assert pc["assembly_hits"] == pc["assembly_misses"] > 0
    for i, rid in enumerate(sorted(out2)):
        np.testing.assert_array_equal(out2[rid].preds, bare[i])
    assert sorted(out1) != sorted(out2)


# ---------------------------------------------------------------------------
# failover + replay (chaos)
# ---------------------------------------------------------------------------

def _busiest(router_stats):
    name, w = max(router_stats["workers"].items(),
                  key=lambda kv: kv[1]["routed"])
    return name, w["ordinal"], w["routed"]


def test_worker_kill_failover_bit_identical(bare):
    """Kill one of 3 workers mid-stream: every request completes with
    predictions bit-identical to the no-fault run, and a follow-up stream
    on the shrunken pool serves clean."""
    with _router(3) as probe:
        probe.serve(SCENES)
        name, ordinal, routed = _busiest(probe.stats())
    assert routed >= 2

    plan = FaultPlan(kill_workers={ordinal: 1})
    r = _router(3, fault_plan=plan)
    try:
        out = r.serve(SCENES)
        st = r.stats()
        assert plan.stats()["workers_killed"] == 1
        assert st["faults"]["failovers"] == 1
        assert st["faults"]["replayed"] >= 1
        assert st["faults"]["recovery_s"] is not None
        assert st["workers"][name]["state"] == "dead"
        assert "crashed" in st["workers"][name]["reason"]
        assert len(out) == len(SCENES)
        for rid in sorted(out):
            assert out[rid].error is None
            np.testing.assert_array_equal(out[rid].preds, bare[rid])
        out2 = r.serve(SCENES)
        assert all(res.error is None for res in out2.values())
        assert r.stats()["n_live"] == 2
    finally:
        r.close()
    assert not any(w["state"] in ("live", "draining")
                   for w in r.stats()["workers"].values())


def test_hung_worker_detected_and_failed_over(bare):
    """A worker that stops beating (injected hang) is declared dead by
    the liveness policy and its work replays; its late results are
    discarded by the ownership check."""
    with _router(2) as probe:
        probe.serve(SCENES)
        name, ordinal, routed = _busiest(probe.stats())
    assert routed >= 2

    # the reference waits 0.8 s of an 8 s hang; a loaded parallel test run
    # can stall a healthy worker's loop for longer, so 4 s of a 30 s hang
    plan = FaultPlan(hang_workers={ordinal: 30.0})
    r = _router(2, fault_plan=plan)
    try:
        r.liveness = LivenessPolicy(beat_s=0.05, miss_beats=80)  # 4 s
        t0 = time.monotonic()
        out = r.serve(SCENES)
        dt = time.monotonic() - t0
        st = r.stats()
        assert plan.stats()["workers_hung"] == 1
        assert st["faults"]["failovers"] == 1
        assert st["workers"][name]["state"] == "dead"
        assert "hung" in st["workers"][name]["reason"]
        assert dt < 30.0, "drain must not wait out the full hang"
        for rid in sorted(out):
            assert out[rid].error is None
            np.testing.assert_array_equal(out[rid].preds, bare[rid])
    finally:
        r.close()


def test_replay_budget_exhaustion_exec_failed():
    """max_replays=0: requests on a killed worker complete with typed
    exec_failed instead of replaying."""
    plan = FaultPlan(kill_workers={0: 0})
    with _router(1, fault_plan=plan, max_replays=0) as r:
        out = r.serve(SCENES)
    assert len(out) == len(SCENES)
    codes = {res.error.code for res in out.values() if res.error}
    assert codes and codes <= {FLT.EXEC_FAILED, FLT.SHED}
    assert any(res.error.code == FLT.EXEC_FAILED
               and "replay budget exhausted" in res.error.message
               for res in out.values())


def test_shed_on_empty_and_saturated_pool(bare):
    """Zero live workers and per-worker backlog saturation both complete
    requests with typed shed results."""
    plan = FaultPlan(kill_workers={0: 0})
    with _router(1, fault_plan=plan) as r:
        out = r.serve(SCENES)
        assert all(res.error is not None for res in out.values())
        assert any(res.error.code == FLT.SHED and
                   "no live workers to replay" in res.error.message
                   for res in out.values())
        c, f, m = SCENES[0]
        rid = r.submit(c, f, m)
        shed = {x.rid: x for x in r.poll()}[rid]
        assert shed.error.code == FLT.SHED
        assert "no live workers in the pool" in shed.error.message

    with _router(1, max_backlog=1) as r:
        c0, f0, m0 = SCENES[0]
        c1, f1, m1 = SCENES[1]
        rid0 = r.submit(c0, f0, m0)
        rid1 = r.submit(c1, f1, m1)
        by_rid = {res.rid: res for res in r.drain()}
        assert by_rid[rid0].error is None
        np.testing.assert_array_equal(by_rid[rid0].preds, bare[0])
        assert by_rid[rid1].error is not None
        assert by_rid[rid1].error.code == FLT.SHED
        assert "max_backlog" in by_rid[rid1].error.message


# ---------------------------------------------------------------------------
# elastic pool
# ---------------------------------------------------------------------------

def test_elastic_add_remove_with_reaffinity(bare):
    """add_worker(): only the keys that rank the newcomer first move;
    remove_worker() drains then leaves and previews revert exactly."""
    r = _router(2)
    try:
        r.serve(SCENES)
        before = [r.preview(c, m) for c, f, m in SCENES]
        new = r.add_worker()
        assert r.stats()["n_live"] == 3
        after = [r.preview(c, m) for c, f, m in SCENES]
        for b, a in zip(before, after):
            assert a == b or a == new
        out = r.serve(SCENES)
        for i, rid in enumerate(sorted(out)):
            assert out[rid].error is None
            np.testing.assert_array_equal(out[rid].preds, bare[i])
        r.remove_worker(new)
        assert r.workers()[new] == "left"
        assert [r.preview(c, m) for c, f, m in SCENES] == before
        out2 = r.serve(SCENES)
        assert all(res.error is None for res in out2.values())
    finally:
        r.close()


def test_router_lifecycle_and_validation():
    factory = _factory()
    with pytest.raises(ValueError, match="n_workers"):
        ServeRouter(factory, 0)
    with pytest.raises(ValueError, match="max_replays"):
        ServeRouter(factory, 1, max_replays=-1)
    with pytest.raises(ValueError, match="max_backlog"):
        ServeRouter(factory, 1, max_backlog=0)
    r = _router(1)
    with pytest.raises(KeyError):
        r.remove_worker("nope")
    with pytest.raises(ValueError, match="already exists"):
        r.add_worker("w0")
    assert r.preview(np.zeros((300, 4), np.int32)) is None  # over the ladder
    r.close()
    r.close()
    c, f, m = SCENES[0]
    rid = r.submit(c, f, m)
    res = {x.rid: x for x in r.poll()}[rid]
    assert res.error.code == FLT.REJECTED
    with pytest.raises(RuntimeError, match="closed"):
        r.add_worker()


def test_stats_aggregation_shape():
    with _router(2) as r:
        r.serve(SCENES)
        st = r.stats()
    assert st["n_workers"] == 2 and st["n_submitted"] == len(SCENES)
    assert st["n_completed"] == len(SCENES) == st["n_ok"]
    assert st["routed_incomplete"] == 0
    pc = st["pool_cache"]
    schedulers = [w["scheduler"] for w in st["workers"].values()]
    assert pc["mapping_misses"] == sum(s["mapping_cache"]["misses"]
                                       for s in schedulers)
    assert pc["assembly_misses"] == sum(s["assembly_cache"]["misses"]
                                        for s in schedulers)
    for w in st["workers"].values():
        assert w["state"] == "live"
        assert w["scheduler"]["n_ok"] == w["processed"]
    for w in r.stats()["workers"].values():
        assert w["state"] == "left"
    assert st["liveness"]["stall_s"] == pytest.approx(
        st["liveness"]["beat_s"] * st["liveness"]["miss_beats"])


def test_two_workers_count_every_launch_once(monkeypatch):
    """Two live worker threads through flow "cuda_fused": a counting stand
    in for the kernel wrapper (it bumps LAUNCHES under the spconv count
    lock, as the wrapper does on the card) sees 13 conv sites a scene,
    none lost to a race, and the labels equal the bare scheduler's."""
    from repro_torch.kernels.spconv import ops
    from repro_torch.kernels.spconv.ref import spconv_fod_fused_ref

    def counting(features, inv, weights, epilogue=None, **kw):
        with TK._COUNT_LOCK:
            TK.LAUNCHES["spconv_fod_fused"] += 1
            TK.LAUNCHES["spconv_fod_fused_tc"] += 1
        return spconv_fod_fused_ref(features, inv, weights, epilogue)

    monkeypatch.setattr(ops, "spconv_fod_fused_cuda", counting)
    factory = PointCloudEngine.factory(mini_module(), 2, device="cpu",
                                       flow="cuda_fused",
                                       ladder=geometric_ladder(64, 128))
    want = ServeScheduler(factory(), max_batch=2).serve(SCENES)
    TK.reset_launch_counts()
    with _router(2, factory=factory) as r:
        out = r.serve(SCENES * 3)
        busy = [w["routed"] for w in r.stats()["workers"].values()]
    assert min(busy) > 0
    assert TK.LAUNCHES["spconv_fod_fused"] == 13 * 3 * len(SCENES)
    assert TK.LAUNCHES["spconv_fod_fused_tc"] == 13 * 3 * len(SCENES)
    for i, rid in enumerate(sorted(out)):
        np.testing.assert_array_equal(out[rid].preds,
                                      want[i % len(SCENES)].preds)


# ---------------------------------------------------------------------------
# observability and overload wiring
# ---------------------------------------------------------------------------

def test_router_stats_schema():
    router = ServeRouter(_factory(), 1, max_batch=2)
    out = router.serve([_scene(0, 40)])
    assert all(r.error is None for r in out.values())
    st = router.stats()
    assert set(st) == MX.ROUTER_STATS_KEYS
    assert set(st["faults"]) == MX.ROUTER_FAULT_KEYS
    assert set(st["latency_quantiles_s"]) == {"p50", "p95", "p99"}
    router.close()
    from repro.obs import metrics as RMX
    assert MX.ROUTER_STATS_KEYS == RMX.ROUTER_STATS_KEYS
    assert MX.ROUTER_FAULT_KEYS == RMX.ROUTER_FAULT_KEYS


def test_router_failover_trace():
    """One trace spans dispatch -> failover -> replay -> retire for a
    victim that was genuinely in flight on the lost worker, with exactly
    one flight-recorder dump.  The first worker's engine delays its
    device waits (the victim is dispatched and waited on), the liveness
    budget runs out during that wait, and the victim replays on the
    other worker; the lost worker's late result is discarded."""
    engines = [_factory()(), _factory()()]

    def pick(name):
        probe = ServeRouter(lambda it=iter(engines): next(it), 2,
                            max_batch=1)
        found = []
        for s in range(24):
            c, f, m = _scene(560 + s, 40)
            if probe.preview(c, m) == name:
                found.append((c, f, m))
            if len(found) == 2:
                break
        probe.close()
        return found

    victims = pick("w0")
    assert len(victims) == 2, "seed sweep found no w0-routed scenes"
    # the plan is set after the probe (closing a scheduler closes its plan)
    slow = FaultPlan(delay_buckets={64: 30.0})
    engines[0].fault_plan = slow
    obs = Observability.enabled()
    it = iter(engines)
    router = ServeRouter(lambda: next(it), 2, max_batch=1, obs=obs)
    router.liveness = LivenessPolicy(beat_s=0.02, miss_beats=200)  # 4 s
    try:
        out = router.serve(victims)
        st = router.stats()
        assert all(r.error is None for r in out.values())
        assert st["faults"]["failovers"] == 1
        assert st["faults"]["replayed"] >= 1
        assert "hung" in st["workers"]["w0"]["reason"]
        assert slow.stats()["delays_injected"] >= 1
    finally:
        slow.close()                    # wake the lost worker's wait
        router.close()

    replayed = [t for t in obs.tracer.finished()
                if "failover" in t.names()]
    assert replayed, "no trace recorded the failover"
    inflight = [t for t in replayed if t.names().count("dispatch") == 2]
    assert inflight, [t.names() for t in replayed]
    trace = inflight[0]
    assert trace.closed
    assert trace.spans[trace.root_id].attrs["outcome"] == "ok"
    names = trace.names()
    i_disp = names.index("dispatch")
    i_fail = names.index("failover")
    i_replay = names.index("replay")
    i_retire = len(names) - 1 - names[::-1].index("retire")
    assert i_disp < i_fail < i_replay < i_retire, names
    assert names.count("admission") == 2
    assert names.count("dispatch") == 2
    assert obs.recorder.stats()["dumps"] == 1
    (dump,) = obs.recorder.dumps
    assert dump["reason"] == "failover"


def test_router_overload_wiring():
    factory = _factory()
    with pytest.raises(TypeError, match="overload="):
        ServeRouter(factory, 1, overload=OverloadController())
    router = ServeRouter(factory, 2, max_batch=2, max_backlog=4,
                         overload=True)
    try:
        for w in router._workers.values():
            assert w.sched.overload is not None
            assert w.sched.overload.policy is router.overload
        assert set(router._breakers) == set(router._workers)
        rids = [router.submit(*_scene(500 + s, 40), priority=1)
                for s in range(4)]
        router.flush()
        out = router.take(rids)
        assert all(out[r].ok for r in rids)
        st = router.stats()
        assert st["router_max_backlog"] == 4
        assert st["max_backlog"] == 4
    finally:
        router.close()


# ---------------------------------------------------------------------------
# parity with the reference router
# ---------------------------------------------------------------------------

def _ref_twin(ref_engine):
    """A second reference engine over the same compiled programs with its
    own (empty) mapping cache: a router worker of its own."""
    from repro.api import MappingCache as RefCache
    twin = copy.copy(ref_engine)
    twin.session = copy.copy(ref_engine.session)
    twin.session.maps_cache = RefCache(32)
    twin._scheduler = None
    return twin


def _router_counts(st):
    """Every count of a router's stats() that does not depend on timing,
    with each worker's scheduler counts."""
    return {
        "top": {k: st[k] for k in (
            "n_workers", "n_live", "n_submitted", "n_completed", "n_ok",
            "routed_incomplete", "liveness", "max_replays", "max_backlog",
            "router_max_backlog", "closed")},
        "pool": st["pool_cache"],
        "faults": {k: v for k, v in st["faults"].items()
                   if k != "recovery_s"},
        "workers": {name: ({k: v for k, v in w.items() if k != "scheduler"},
                           _counts(w["scheduler"]))
                    for name, w in st["workers"].items()},
    }


@pytest.mark.parametrize("port_depth,flow", [(0, "fod"), (2, "cuda_fused")])
def test_router_matches_reference_router(reference, port_depth, flow):
    """The same stream through the reference's 2-worker ServeRouter and
    the port's: every scene previewed onto and served by the same worker,
    labels equal on valid rows, every count of stats() equal."""
    from repro.api import MappingCache as RefCache
    from repro.serve.router import ServeRouter as RefRouter

    ref_engine, module = reference
    ref_engine.session.maps_cache = RefCache(32)
    ref_engine._scheduler = None
    ref_engines = iter([ref_engine, _ref_twin(ref_engine)])
    scenes = _stream()
    want_r = RefRouter(lambda: next(ref_engines), 2, max_batch=2,
                       mesh=None, pipeline_depth=0,
                       assembly_cache_entries=2)
    got_r = ServeRouter(PointCloudEngine.factory(
        module, 2, device="cpu", flow=flow, ladder=geometric_ladder(*LADDER)),
        2, max_batch=2, pipeline_depth=port_depth, assembly_cache_entries=2)
    try:
        want_p = [want_r.preview(c, m) for c, m, f in scenes]
        assert [got_r.preview(c, m) for c, m, f in scenes] == want_p
        assert len(set(want_p)) == 2
        want = want_r.serve([(c, f, m) for c, m, f in scenes])
        got = got_r.serve([(c, f, m) for c, m, f in scenes])
        want_st, got_st = want_r.stats(), got_r.stats()
    finally:
        want_r.close()
        got_r.close()
    assert sorted(got) == sorted(want) == list(range(len(scenes)))
    for rid, (c, m, f) in enumerate(scenes):
        r, w = got[rid], want[rid]
        assert r.ok and w.ok and r.bucket == w.bucket
        assert r.mapping_hit == w.mapping_hit
        np.testing.assert_array_equal(r.preds[m], np.asarray(w.preds)[m])
    assert set(got_st) == set(want_st)
    assert _router_counts(got_st) == _router_counts(want_st)
    routed = {n: w["routed"] for n, w in got_st["workers"].items()}
    assert routed == {n: want_p.count(n) for n in routed}
    assert got_st["pool_cache"]["mapping_hits"] > 0
