"""Port of the fault-tolerant serving runtime, on the CPU at mini-MinkUNet
size: the error taxonomy and admission validation (`serve/faults.py`),
the scheduler's failure-isolation policies (rejected / shed / timeout /
exec_failed results, retry + bisect poison isolation, bounded backlog,
per-request deadlines), the watchdog + close() lifecycle
(`launch/fault_tolerance.py` Ticker), and `segment_batch`'s per-scene
errors.  Mirrors tests/test_serve_faults.py; predictions are held against
`PointCloudEngine.segment` of the same weights and ladder (the code each
micro-batch scene runs), which tests/test_torch_engine.py holds against
the reference.  `validate_scene` also runs beside the reference's on the
same malformed scenes."""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import buckets as RBK
from repro.serve import faults as RFLT
from repro_torch.core import mapping as M
from repro_torch.core import packed as PK
from repro_torch.data.synthetic import lidar_scene
from repro_torch.launch.fault_tolerance import Heartbeat, Pulse, Ticker
from repro_torch.models import minkunet as TMU
from repro_torch.serve import faults as FLT
from repro_torch.serve.buckets import BucketLadder, geometric_ladder
from repro_torch.serve.engine import PointCloudEngine
from repro_torch.serve.faults import (AdmissionError, FaultPlan,
                                      InjectedFault, ServeError,
                                      validate_scene)
from repro_torch.serve.scheduler import ServeScheduler


@functools.lru_cache(maxsize=None)
def mini_module(n_classes=2):
    return TMU.mini_minkunet_init(torch.Generator().manual_seed(0), c_in=4,
                                  n_classes=n_classes)


def mini_engine(lo=64, hi=128, **kw):
    return PointCloudEngine(mini_module(), 2, device="cpu",
                            ladder=geometric_ladder(lo, hi), **kw)


@functools.lru_cache(maxsize=None)
def _segment_engine(lo, hi):
    return mini_engine(lo, hi)


def seg_preds(coords, mask, feats, ladder=(64, 128)):
    """Labels of `segment` on a private engine over the same weights and
    ladder: what every scheduled scene must equal."""
    preds, _ = _segment_engine(*ladder).segment(coords, mask, feats)
    return preds.numpy()


def _scene_cf(seed, n):
    c, m, f = lidar_scene(seed=140 + seed, n_points=n, grid=16)
    return c, f, m


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module, restored after.  The port's CPU
    path runs many small ops; in a parallel test run every process starts
    one intra-op thread a core, the processes together oversubscribe the
    cores, and each op's barrier then waits on descheduled threads (a test
    of 3 s alone took 957 s in a six-process run).  Files that import this
    fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    return mini_engine()


# ---------------------------------------------------------------------------
# taxonomy + validation units (no engine)
# ---------------------------------------------------------------------------

def test_serve_error_taxonomy():
    err = ServeError(FLT.EXEC_FAILED, "boom")
    assert str(err) == "[exec_failed] boom"
    with pytest.raises(ValueError, match="unknown serve error code"):
        ServeError("oom", "nope")
    adm = AdmissionError("bad scene")
    assert isinstance(adm, ValueError)
    e = adm.as_error()
    assert e.code == FLT.REJECTED and e.message == "bad scene"
    assert set(FLT.ERROR_CODES) == {"rejected", "timeout", "shed",
                                    "exec_failed"}


def test_validate_scene_rejections():
    ladder = BucketLadder((64, 128))
    c, f, m = _scene_cf(0, 40)

    def reject(match, **kw):
        args = {"coords": c, "feats": f, "mask": m}
        args.update(kw)
        with pytest.raises(AdmissionError, match=match):
            validate_scene(args["coords"], args["feats"], args["mask"],
                           ladder)

    vc, vm, vf, n, cap = validate_scene(c, f, m, ladder)
    assert (n, cap) == (40, 64)
    np.testing.assert_array_equal(vc, c)

    reject("must be", coords=c[:, 0])
    reject("does not match", feats=f[:-1])
    reject("does not match", mask=m[:-1])
    reject("not integer-compatible", coords=c.astype(np.complex64))
    reject("NaN/Inf", coords=np.where(c == c[0, 0], np.nan,
                                      c.astype(np.float32)))
    bad_f = f.copy()
    bad_f[np.flatnonzero(m)[0]] = np.nan
    reject("NaN/Inf", feats=bad_f)
    masked_f = f.copy()
    dead = np.flatnonzero(~m)
    if dead.size:
        masked_f[dead[0]] = np.nan
        validate_scene(c, masked_f, m, ladder)
    reject("exceeds the bucket ladder", coords=np.tile(c, (5, 1)),
           feats=np.tile(f, (5, 1)), mask=np.tile(m, 5))

    row = np.flatnonzero(m)[0]
    over = c.astype(np.int64)
    over[row, 1] = PK.COORD_MAX + 1
    with pytest.raises(AdmissionError, match="packed-key budget"):
        validate_scene(over, f, m, ladder)
    bad_batch = c.astype(np.int64)
    bad_batch[row, 0] = PK.BATCH_MAX + 1
    with pytest.raises(AdmissionError, match="packed-key budget"):
        validate_scene(bad_batch, f, m, ladder)
    validate_scene(over, f, m, ladder, check_key_budget=False)
    # an all-sentinel spatial row is padding, exempt from the budget
    pad = c.astype(np.int64)
    pad[row, 1:] = M.SENTINEL
    validate_scene(pad, f, m, ladder)

    with pytest.raises(AdmissionError, match="stream"):
        validate_scene(c, f, m, ladder, coord_dim=5)
    with pytest.raises(AdmissionError, match="stream"):
        validate_scene(c, f, m, ladder, feat_shape=(f.shape[1] + 1,))
    _, vm, _, _, _ = validate_scene(c, f, None, ladder)
    assert vm.all() and vm.shape == (40,)


def _malformed(case):
    """(coords, feats, mask, keyword arguments) of one admission case:
    a clean scene, or one broken in a single way."""
    c, f, m = _scene_cf(0, 40)
    row = np.flatnonzero(m)[0]
    kw = {}
    if case == "drop_coord_axis":
        c = c[:, 0]
    elif case == "short_feats":
        f = f[:-1]
    elif case == "short_mask":
        m = m[:-1]
    elif case == "complex_coords":
        c = c.astype(np.complex64)
    elif case == "nan_coord":
        c = c.astype(np.float32)
        c[row, 2] = np.nan
    elif case == "nan_feat":
        f = f.copy()
        f[row] = np.nan
    elif case == "nan_feat_masked":
        f = f.copy()
        f[np.flatnonzero(~m)[:1]] = np.nan
    elif case == "oversized":
        c, f, m = np.tile(c, (5, 1)), np.tile(f, (5, 1)), np.tile(m, 5)
    elif case in ("coord_over_budget", "coord_over_budget_unchecked"):
        c = c.astype(np.int64)
        c[row, 1] = PK.COORD_MAX + 1
        kw["check_key_budget"] = case == "coord_over_budget"
    elif case == "batch_over_budget":
        c = c.astype(np.int64)
        c[row, 0] = PK.BATCH_MAX + 1
    elif case == "sentinel_row":
        c = c.astype(np.int64)
        c[row, 1:] = M.SENTINEL
    elif case == "coord_dim":
        kw["coord_dim"] = 5
    elif case == "feat_shape":
        kw["feat_shape"] = (f.shape[1] + 1,)
    elif case == "no_mask":
        m = None
    elif case == "float_mask":
        m = m.astype(np.float32)
    return c, f, m, kw


def _admit(flt, ladder, case):
    c, f, m, kw = _malformed(case)
    try:
        out = flt.validate_scene(c, f, m, ladder, **kw)
    except flt.AdmissionError as e:
        return ("rejected", e.code, e.detail, str(e))
    arrays = [np.asarray(a) for a in out]
    return ("admitted",) + tuple((a.dtype.str, a.shape, a.tobytes())
                                 for a in arrays)


@pytest.mark.parametrize("case", [
    "clean", "drop_coord_axis", "short_feats", "short_mask",
    "complex_coords", "nan_coord", "nan_feat", "nan_feat_masked",
    "oversized", "coord_over_budget", "coord_over_budget_unchecked",
    "batch_over_budget", "sentinel_row", "coord_dim", "feat_shape",
    "no_mask", "float_mask"])
def test_validate_scene_matches_reference(case):
    got = _admit(FLT, BucketLadder((64, 128)), case)
    want = _admit(RFLT, RBK.BucketLadder((64, 128)), case)
    assert got == want
    assert FLT.ERROR_CODES == RFLT.ERROR_CODES
    assert (FLT.OVERSIZED, FLT.MALFORMED) == (RFLT.OVERSIZED,
                                              RFLT.MALFORMED)


def test_fault_plan_seams():
    plan = FaultPlan(fail_dispatches={1}, poison_rids={7},
                     corrupt_scenes={0}, delay_buckets={64: 0.01})
    c, f, m = _scene_cf(1, 8)
    _, cf, _ = plan.on_submit(c, f, m)
    assert np.isnan(cf).any() and not np.isnan(f).any()
    _, cf2, _ = plan.on_submit(c, f, m)
    assert not np.isnan(np.asarray(cf2, np.float32)).any()

    plan.check_wait(0, 128, [1, 2])
    t0 = time.monotonic()
    with pytest.raises(InjectedFault, match="dispatch 1"):
        plan.check_wait(1, 64, [3])
    assert time.monotonic() - t0 >= 0.01
    with pytest.raises(InjectedFault, match="poisoned"):
        plan.check_wait(5, 128, [6, 7])
    assert plan.stats() == {"submits_seen": 2, "scenes_corrupted": 1,
                            "failures_injected": 2, "delays_injected": 1,
                            "workers_killed": 0, "workers_hung": 0,
                            "slowdowns_injected": 0, "storm_paced": 0}


def test_fault_plan_worker_seams():
    plan = FaultPlan(kill_workers={0: 2}, hang_workers={1: 0.06})
    plan.on_worker_step(0, 0)
    plan.on_worker_step(0, 1)
    with pytest.raises(InjectedFault, match=r"worker 0, step 2"):
        plan.on_worker_step(0, 2)
    t0 = time.monotonic()
    plan.on_worker_step(1, 0)               # cold worker: no hang yet
    assert time.monotonic() - t0 < 0.05
    t0 = time.monotonic()
    plan.on_worker_step(1, 1)               # warm: hangs once
    assert time.monotonic() - t0 >= 0.06
    t0 = time.monotonic()
    plan.on_worker_step(1, 2)
    assert time.monotonic() - t0 < 0.05
    st = plan.stats()
    assert st["workers_killed"] == 1 and st["workers_hung"] == 1


def test_fault_plan_close_wakes_injected_waits():
    plan = FaultPlan(delay_buckets={64: 30.0}, hang_workers={0: 30.0},
                     slow_device=30.0)
    done = []

    def waiter():
        plan.check_wait(0, 64, [0])
        plan.on_worker_step(0, 1)
        done.append(time.monotonic())

    th = threading.Thread(target=waiter)
    t0 = time.monotonic()
    th.start()
    time.sleep(0.05)
    assert not done and not plan.closed
    plan.close()
    th.join(5.0)
    assert done and done[0] - t0 < 5.0 and plan.closed
    with pytest.raises(ValueError, match="storm_buckets"):
        FaultPlan(storm_buckets={64: 0.0})


def test_ticker_pulse_and_heartbeat_close_join():
    ticks = []
    with Ticker(0.01, lambda: ticks.append(1), name="t-test") as t:
        time.sleep(0.05)
        assert t.alive
    assert not t.alive and len(ticks) >= 1
    n = len(ticks)
    time.sleep(0.03)
    assert len(ticks) == n
    with pytest.raises(ValueError, match="interval"):
        Ticker(0.0, lambda: None)

    boom = []
    t2 = Ticker(0.01, lambda: boom.append(1) or (_ for _ in ()).throw(
        RuntimeError("tick boom")))
    time.sleep(0.05)
    t2.close()
    assert len(boom) >= 2 and not t2.alive

    pulse = Pulse()
    time.sleep(0.02)
    assert pulse.stalled(0.01) and pulse.age() >= 0.02
    pulse.beat()
    assert not pulse.stalled(1.0)

    stalls = []
    hb = Heartbeat(stall_s=0.04, on_stall=stalls.append)
    time.sleep(0.08)
    assert stalls and stalls[0] > 0.04
    hb.beat()
    hb.close()
    assert not hb._ticker.alive


# ---------------------------------------------------------------------------
# scheduler failure policies
# ---------------------------------------------------------------------------

def test_submit_rejects_malformed_scenes_without_raising(engine):
    sched = ServeScheduler(engine, max_batch=2)
    c, f, m = _scene_cf(2, 40)
    bad_f = f.copy()
    bad_f[m.argmax()] = np.nan
    r1 = sched.take([sched.submit(c, bad_f, m)]).popitem()[1]
    assert r1.error.code == "rejected" and "NaN" in r1.error.message
    r2 = sched.take([sched.submit(c, f[:-1], m)]).popitem()[1]
    assert r2.error.code == "rejected"
    r3 = sched.take([sched.submit(*_scene_cf(3, 4000))]).popitem()[1]
    assert "exceeds the bucket ladder" in r3.error.message
    assert r3.error.detail == FLT.OVERSIZED and r3.bucket == -1

    good = sched.submit(c, f, m)
    sched.flush()
    ok = sched.take([good])[good]
    assert ok.ok and ok.error is None
    np.testing.assert_array_equal(ok.preds, seg_preds(c, m, f))
    r4 = sched.take([sched.submit(c[:, :3], f, m)]).popitem()[1]
    assert r4.error.code == "rejected" and "stream" in r4.error.message

    st = sched.stats()
    assert st["n_submitted"] == 5 and st["n_completed"] == 5
    assert st["n_ok"] == 1 and st["faults"]["rejected"] == 4
    # validate=False: no admission control, a ladder overflow raises
    raw = ServeScheduler(engine, max_batch=2, validate=False)
    with pytest.raises(ValueError, match="exceeds the bucket ladder"):
        raw.submit(*_scene_cf(3, 4000))


def test_shed_policy_bounds_per_bucket_backlog(engine):
    sched = ServeScheduler(engine, max_batch=2, pipeline_depth=2,
                           max_backlog=2)
    a, b, cst = _scene_cf(4, 40), _scene_cf(5, 40), _scene_cf(6, 40)
    r1 = sched.submit(*a)
    r2 = sched.submit(*b)                       # fills the bucket: parked
    r3 = sched.submit(*cst)                     # backlog 2 >= 2: shed
    out = sched.take([r1, r2, r3])
    assert out[r1].ok and out[r2].ok
    assert out[r3].error.code == "shed"
    assert "max_backlog" in out[r3].error.message
    assert out[r3].error.retry_after_s is None  # no controller, no hint
    np.testing.assert_array_equal(out[r1].preds,
                                  seg_preds(a[0], a[2], a[1]))
    r4 = sched.submit(*cst)
    sched.flush()
    assert sched.take([r4])[r4].ok
    st = sched.stats()
    assert st["faults"]["shed"] == 1 and st["n_ok"] == 3


def test_deadline_s_times_out_overdue_queued_requests(engine):
    sched = ServeScheduler(engine, max_batch=4, watchdog_s=0)
    a, b = _scene_cf(7, 40), _scene_cf(8, 40)
    r1 = sched.submit(*a, deadline_s=0.01)
    r2 = sched.submit(*b)
    time.sleep(0.03)
    polled = {r.rid: r for r in sched.poll()}
    st = sched.stats()
    assert st["faults"]["timeout"] == 1 and st["queue_depth"] == 1
    sched.flush()
    out = {**polled, **sched.take([r1, r2])}
    assert out[r1].error.code == "timeout"
    assert "deadline_s" in out[r1].error.message
    assert out[r2].ok
    np.testing.assert_array_equal(out[r2].preds,
                                  seg_preds(b[0], b[2], b[1]))


@pytest.mark.parametrize("backoff_s", [0.0, 0.05])
def test_transient_dispatch_failure_retries_bit_identical(engine,
                                                          backoff_s):
    """A one-shot dispatch failure is retried (bisected into singles):
    every request completes with the fault-free labels; the backoff, when
    asked for, is slept and counted, and is 0 by default."""
    plan = FaultPlan(fail_dispatches={0})
    sched = ServeScheduler(engine, max_batch=2, fault_plan=plan,
                           retry_backoff_s=backoff_s)
    scenes = [_scene_cf(i, 40) for i in (9, 10)]
    t0 = time.monotonic()
    out = sched.serve(scenes)
    dt = time.monotonic() - t0
    sched.close()
    assert all(r.ok for r in out.values())
    for rid, (c, f, m) in zip(sorted(out), scenes):
        np.testing.assert_array_equal(out[rid].preds, seg_preds(c, m, f))
    st = sched.stats()["faults"]
    assert st["failed_dispatches"] == 1 and st["exec_failed"] == 0
    assert st["retries"] == 2
    assert st["recovery_s"] is not None and st["recovery_s"] >= 0
    assert plan.stats()["failures_injected"] == 1
    if backoff_s:
        assert st["retry_backoff_s"] >= 0.5 * backoff_s
        assert dt >= 0.5 * backoff_s
    else:
        assert st["retry_backoff_s"] == 0.0
    with pytest.raises(ValueError, match="retry_backoff_s"):
        ServeScheduler(engine, retry_backoff_s=-0.1)


def test_poison_scene_isolated_by_bisect(engine):
    plan = FaultPlan(poison_rids={1})
    sched = ServeScheduler(engine, max_batch=4, fault_plan=plan)
    scenes = [_scene_cf(20 + i, 40) for i in range(4)]
    out = sched.serve(scenes)
    assert out[1].error.code == "exec_failed"
    assert "injected" in out[1].error.message
    for rid, (c, f, m) in zip(sorted(out), scenes):
        if rid == 1:
            continue
        assert out[rid].ok
        np.testing.assert_array_equal(out[rid].preds, seg_preds(c, m, f))
    st = sched.stats()["faults"]
    assert st["exec_failed"] == 1
    assert st["failed_dispatches"] == 3
    assert st["retries"] == 4
    follow = _scene_cf(30, 40)
    (res,) = sched.serve([follow]).values()
    assert res.ok
    np.testing.assert_array_equal(
        res.preds, seg_preds(follow[0], follow[2], follow[1]))


def test_retry_disabled_completes_exec_failed(engine):
    plan = FaultPlan(fail_dispatches={0})
    sched = ServeScheduler(engine, max_batch=2, fault_plan=plan,
                           max_retries=0, retry_bisect=False)
    out = sched.serve([_scene_cf(i, 40) for i in (11, 12)])
    assert all(r.error.code == "exec_failed" for r in out.values())
    st = sched.stats()["faults"]
    assert st["retries"] == 0 and st["exec_failed"] == 2
    with pytest.raises(ValueError, match="max_retries"):
        ServeScheduler(engine, max_retries=-1)
    with pytest.raises(ValueError, match="max_backlog"):
        ServeScheduler(engine, max_backlog=0)


def test_watchdog_background_completion_and_join(engine):
    sched = ServeScheduler(engine, max_batch=4, max_wait_s=0.05)
    assert sched.stats()["watchdog"]
    c, f, m = _scene_cf(13, 40)
    rid = sched.submit(c, f, m)
    deadline = time.monotonic() + 60.0
    while sched.stats()["n_completed"] < 1:     # stats() never executes
        assert time.monotonic() < deadline, "watchdog never completed it"
        time.sleep(0.02)
    st = sched.stats()
    assert st["deadline_flushes"] >= 1 and st["in_flight"] == 0
    res = sched.take([rid])[rid]
    np.testing.assert_array_equal(res.preds, seg_preds(c, m, f))
    wd = sched._watchdog
    assert wd.alive
    sched.close()
    assert not wd.alive and sched._watchdog is None


def test_close_context_manager_drains_and_rejects_late_submits(engine):
    with ServeScheduler(engine, max_batch=4, max_wait_s=5.0) as sched:
        c, f, m = _scene_cf(14, 40)
        rid = sched.submit(c, f, m)             # partial: still queued
    st = sched.stats()
    assert st["closed"] and st["queue_depth"] == 0 and st["in_flight"] == 0
    res = sched.take([rid])[rid]
    assert res.ok
    np.testing.assert_array_equal(res.preds, seg_preds(c, m, f))
    late = sched.submit(c, f, m)
    out = sched.take([late])[late]
    assert out.error.code == "rejected" and "closed" in out.error.message
    sched.close()                               # idempotent


def test_segment_batch_surfaces_per_scene_errors():
    plan = FaultPlan(corrupt_scenes={1, 3})
    engine = mini_engine(64, 64, max_batch=2, fault_plan=plan)
    scenes = [lidar_scene(seed=160 + i, n_points=40, grid=16)
              for i in range(2)]
    coords = np.stack([c for c, _, _ in scenes])
    mask = np.stack([m for _, m, _ in scenes])
    feats = np.stack([f for _, _, f in scenes])

    preds, hit, errors = engine.segment_batch(coords, mask, feats,
                                              on_error="partial")
    assert set(errors) == {1} and errors[1].code == "rejected"
    assert preds.dtype == torch.int32 and (preds[1] == -1).all()
    c, m, f = scenes[0]
    np.testing.assert_array_equal(preds[0].numpy(),
                                  seg_preds(c, m, f, ladder=(64, 64)))
    with pytest.raises(RuntimeError, match="scene 1.*rejected"):
        engine.segment_batch(coords, mask, feats)
    with pytest.raises(ValueError, match="on_error"):
        engine.segment_batch(coords, mask, feats, on_error="ignore")


def test_failing_readiness_query_propagates(engine, monkeypatch):
    """The port's readiness check does not swallow errors: a slot whose
    query raises makes poll() raise, and the slot stays in flight."""
    from repro_torch.serve import scheduler as S

    sched = ServeScheduler(engine, max_batch=1, pipeline_depth=2,
                           watchdog_s=0)
    sched.submit(*_scene_cf(15, 40))
    assert sched.stats()["in_flight"] == 1

    def broken(self):
        raise RuntimeError("readiness query failed")

    monkeypatch.setattr(S._InFlight, "ready", broken)
    with pytest.raises(RuntimeError, match="readiness query failed"):
        sched.poll()
    assert sched.stats()["in_flight"] == 1
    monkeypatch.undo()
    assert len(sched.drain()) == 1
