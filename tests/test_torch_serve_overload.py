"""Port of SLO-aware overload control (`serve/overload.py`), on the CPU:
the circuit-breaker state machine (trip / half-open probe / probe
takeover, on an injected clock), the rate estimator and Little's-law
effective backlog bound, the brownout ladder's knob mutation and
restore, the controller's admission gate (adaptive, priority-lane and
breaker sheds, each with a `retry_after_s` hint) over a fake scheduler,
and at mini-MinkUNet size: seeded retry backoff, priority/EDF lane order
under deferred dispatch, controller-off bit identity, and the 2x-capacity
storm.  Mirrors tests/test_serve_overload.py (its router case is mirrored
in tests/test_torch_serve_router.py); the breaker and the controller are also driven
beside the reference's on the same event scripts.  The lane test is deterministic here: no deadline
flushes, explicit flush(), and it compares dispatch order and rids."""

import math
import threading
import time

import numpy as np
import pytest

from repro import obs as RefObs
from repro.serve import overload as ROV
from repro_torch import obs as TObs
from repro_torch.data.synthetic import lidar_scene
from repro_torch.obs import Observability
from repro_torch.obs import metrics as MX
from repro_torch.serve import faults as FLT
from repro_torch.serve import overload as OV
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.overload import (BreakerPolicy, BrownoutPolicy,
                                        CircuitBreaker, OverloadController,
                                        OverloadPolicy, ServeSLO,
                                        resolve_controller)
from repro_torch.serve.scheduler import ServeScheduler
from tests.test_torch_serve_faults import (  # noqa: F401 (a fixture)
    mini_engine, one_torch_thread, seg_preds)


def _scene(seed, n):
    c, m, f = lidar_scene(seed=940 + seed, n_points=n, grid=16)
    return c, f, m


@pytest.fixture(scope="module")
def engine():
    return mini_engine()


# ---------------------------------------------------------------------------
# circuit breaker state machine (no engine, injected clock)
# ---------------------------------------------------------------------------

_BP = BreakerPolicy(k_failures=3, window_s=1.0, cooldown_s=0.5)


def test_breaker_trips_and_recovers():
    br = CircuitBreaker(_BP)
    assert br.state == OV.CLOSED and br.allow(0.0)
    assert not br.record_failure(0.0)
    assert not br.record_failure(0.1)
    assert br.record_failure(0.2)           # k-th failure in window trips
    assert br.state == OV.OPEN and br.n_trips == 1
    assert not br.allow(0.3)                # cooling down
    assert br.retry_after(0.3) == pytest.approx(0.4)
    assert br.allow(0.71)                   # first allow IS the probe
    assert br.state == OV.HALF_OPEN
    br.record_success(0.72)                 # probe succeeded
    assert br.state == OV.CLOSED
    # the failure window was cleared: two fresh failures do not trip
    assert not br.record_failure(0.8)
    assert not br.record_failure(0.9)
    assert br.state == OV.CLOSED


def test_breaker_probe_failure_and_takeover():
    br = CircuitBreaker(_BP)
    for t in (0.0, 0.1, 0.2):
        br.record_failure(t)
    assert br.state == OV.OPEN
    assert br.allow(0.8)                    # probe slot
    assert br.record_failure(0.9)           # failed probe re-trips
    assert br.state == OV.OPEN and br.n_trips == 2
    assert not br.allow(1.0)
    assert br.allow(1.5)                    # next probe
    # probe outstanding: no second admission inside the cooldown...
    assert not br.allow(1.6)
    # ...but a probe that never resolves is taken over after cooldown_s
    assert br.allow(2.1)
    assert br.state == OV.HALF_OPEN


def test_breaker_window_prunes_old_failures():
    br = CircuitBreaker(_BP)
    br.record_failure(0.0)
    br.record_failure(0.1)
    # the first two fall out of the 1s window before the third lands
    assert not br.record_failure(1.5)
    assert br.state == OV.CLOSED


# ---------------------------------------------------------------------------
# policy validation + controller resolution
# ---------------------------------------------------------------------------

def test_policy_validation():
    with pytest.raises(ValueError, match="k_failures"):
        BreakerPolicy(k_failures=0)
    with pytest.raises(ValueError, match="window_s"):
        BreakerPolicy(window_s=0.0)
    with pytest.raises(ValueError, match="deadline_headroom_s"):
        ServeSLO(deadline_headroom_s=0.0)
    with pytest.raises(ValueError, match="wait_shrink"):
        BrownoutPolicy(wait_shrink=0.0)
    with pytest.raises(ValueError, match="escalate"):
        BrownoutPolicy(escalate_after_s=-1.0)
    with pytest.raises(ValueError, match="tick_s"):
        OverloadPolicy(tick_s=0.0)
    with pytest.raises(ValueError, match="ewma_alpha"):
        OverloadPolicy(ewma_alpha=1.5)
    with pytest.raises(ValueError, match="min_backlog"):
        OverloadPolicy(min_backlog=0)


def test_resolve_controller():
    assert resolve_controller(None) is None
    assert resolve_controller(False) is None
    ctrl = resolve_controller(True)
    assert isinstance(ctrl, OverloadController)
    pol = OverloadPolicy(tick_s=0.1)
    assert resolve_controller(pol).policy is pol
    assert resolve_controller(ctrl) is ctrl
    with pytest.raises(TypeError, match="overload="):
        resolve_controller("adaptive")


# ---------------------------------------------------------------------------
# controller units over a fake scheduler (injected clock, no engine)
# ---------------------------------------------------------------------------

class _FakeSched:
    """Just the scheduler surface the controller reads/writes: the obs
    bundle, the latency histogram, the outstanding map, and the knobs
    the brownout ladder mutates.  (Completions reach the estimator via
    `record_dispatch_success`, not through scheduler state.)"""

    def __init__(self, max_backlog=None, max_wait_s=0.2, pipeline_depth=2,
                 obs_pkg=TObs):
        self.obs = obs_pkg.Observability.enabled()
        self.instance = "fake"
        self.max_backlog = max_backlog
        self.max_wait_s = max_wait_s
        self.pipeline_depth = pipeline_depth
        self._h_latency = self.obs.registry.histogram(
            "serve_request_latency_seconds", "",
            ("instance",)).labels(self.instance)
        self._outstanding = {}

    def max_batch_for(self, cap):
        return 1


def _bound_ctrl(sched, **policy_kw):
    now = [0.0]
    ctrl = OverloadController(OverloadPolicy(**policy_kw),
                              clock=lambda: now[0])
    ctrl.bind(sched)
    return ctrl, now


def test_rate_estimation_and_effective_backlog():
    sched = _FakeSched(max_backlog=4)
    ctrl, _ = _bound_ctrl(
        sched, slo=ServeSLO(deadline_headroom_s=0.5), ewma_alpha=0.5)
    ctrl.tick(0.0)                          # snapshot only
    assert ctrl.service_rate(64) is None
    assert ctrl.effective_backlog(64) == 4  # cold start: static bound
    ctrl.record_dispatch_success(64, 10)
    ctrl.tick(1.0)                          # first estimate = 10/s
    assert ctrl.service_rate(64) == pytest.approx(10.0)
    # Little's law: ceil(10 x 0.5) = 5, clamped by the static 4
    assert ctrl.effective_backlog(64) == 4
    ctrl.record_dispatch_success(64, 2)
    ctrl.tick(2.0)                          # EWMA folds in 2/s
    assert ctrl.service_rate(64) == pytest.approx(6.0)
    assert ctrl.effective_backlog(64) == math.ceil(6.0 * 0.5)
    # retry hint: (outstanding - bound + 1) / rate
    assert ctrl.retry_after(64, 8) == pytest.approx((8 - 3 + 1) / 6.0)
    # zero-completion ticks while busy are burstiness, not signal: the
    # estimate (and with it the bound) holds instead of whipsawing
    for t in (3.0, 4.0, 5.0, 6.0, 7.0, 8.0):
        sched._outstanding[64] = 1          # busy, but nothing completes
        ctrl.tick(t)
    assert ctrl.service_rate(64) == pytest.approx(6.0)
    assert ctrl.effective_backlog(64) >= ctrl.policy.min_backlog


def test_idle_bucket_keeps_estimate():
    sched = _FakeSched()
    ctrl, _ = _bound_ctrl(sched)
    ctrl.tick(0.0)
    ctrl.record_dispatch_success(128, 20)
    ctrl.tick(1.0)
    rate = ctrl.service_rate(128)
    assert rate == pytest.approx(20.0)
    # idle (no delta, nothing outstanding): the estimate survives
    ctrl.tick(2.0)
    ctrl.tick(3.0)
    assert ctrl.service_rate(128) == rate


def test_admission_adaptive_shed_carries_retry_hint():
    sched = _FakeSched(max_backlog=10)
    ctrl, now = _bound_ctrl(sched,
                            slo=ServeSLO(deadline_headroom_s=0.1))
    ctrl.tick(0.0)
    ctrl.record_dispatch_success(64, 10)
    now[0] = 1.0
    # rate 10/s -> ceil(10 x 0.1) = 1, floored at 2 full micro-batches
    ctrl.tick(1.0)
    assert ctrl.effective_backlog(64) == 2
    err = ctrl.check_admission_locked(64, outstanding=5, priority=0)
    assert err is not None and err.code == FLT.SHED
    assert "adaptive bound" in err.message
    assert err.retry_after_s == pytest.approx((5 - 2 + 1) / 10.0)
    # under the bound: admitted
    assert ctrl.check_admission_locked(64, outstanding=0,
                                       priority=0) is None


def test_brownout_ladder_escalates_and_recovers():
    sched = _FakeSched(max_backlog=10, max_wait_s=0.2, pipeline_depth=2)
    ctrl, now = _bound_ctrl(
        sched, slo=ServeSLO(deadline_headroom_s=0.1), tick_s=0.01,
        brownout=BrownoutPolicy(escalate_after_s=0.5, recover_after_s=1.0,
                                wait_shrink=0.5, depth_cap=1,
                                shed_below_priority=1))
    ctrl.tick(0.0)
    ctrl.record_dispatch_success(64, 10)
    ctrl.tick(1.0)                          # rate 10/s -> bound 2
    sched._outstanding[64] = 5              # pinned over the bound
    ctrl.record_dispatch_success(64, 1)     # keep the bucket busy
    ctrl.tick(1.1)                          # pressure starts
    for i, t in enumerate((1.7, 2.3, 2.9)):  # one escalation per window
        ctrl.record_dispatch_success(64, 1)
        ctrl.tick(t)
        assert ctrl.level == i + 1
    assert ctrl.level == 3
    assert sched.max_wait_s == pytest.approx(0.1)       # level 1
    assert sched.pipeline_depth == 1                    # level 2
    # level 3: the lane below shed_below_priority is browned out
    now[0] = 2.95
    err = ctrl.check_admission_locked(64, outstanding=0, priority=0)
    assert err is not None and err.code == FLT.SHED
    assert "brownout" in err.message
    assert err.retry_after_s is not None
    assert ctrl.check_admission_locked(64, outstanding=0,
                                       priority=1) is None
    # calm -> stepwise recovery, knobs restored in reverse
    sched._outstanding[64] = 0
    for t in (3.0, 4.1, 5.2, 6.3):
        ctrl.tick(t)
    assert ctrl.level == 0
    assert sched.max_wait_s == pytest.approx(0.2)
    assert sched.pipeline_depth == 2
    assert ctrl.n_transitions == 6
    # every transition was a flight-recorder incident...
    kinds = [d["reason"] for d in sched.obs.recorder.dumps]
    assert kinds.count("brownout") == 6
    # ...and a span event on the controller trace, closed by close()
    ctrl.close()
    trace = sched.obs.tracer.get("fake:overload")
    assert trace is not None and trace.closed
    assert sched.obs.registry.gauge(
        "serve_overload_state",
        labelnames=("instance",)).labels("fake").value == 0


def test_bucket_breaker_sheds_admission():
    sched = _FakeSched()
    ctrl, now = _bound_ctrl(sched, breaker=_BP)
    for t in (0.0, 0.1, 0.2):
        now[0] = t
        ctrl.record_dispatch_failure(64)
    assert ctrl.bucket_breaker(64).state == OV.OPEN
    now[0] = 0.3
    err = ctrl.check_admission_locked(64, outstanding=0, priority=0)
    assert err is not None and err.code == FLT.SHED
    assert "circuit breaker" in err.message
    assert err.retry_after_s == pytest.approx(0.4)
    # a breaker trip is a recorder incident too
    assert any(d["reason"] == "breaker_trip"
               for d in sched.obs.recorder.dumps)
    # cooldown over: the next admission is the half-open probe
    now[0] = 0.8
    assert ctrl.check_admission_locked(64, outstanding=0,
                                       priority=0) is None
    ctrl.record_dispatch_success(64)
    assert ctrl.bucket_breaker(64).state == OV.CLOSED


# ---------------------------------------------------------------------------
# same event scripts through the reference and the port (no engine)
# ---------------------------------------------------------------------------

def _breaker_log(ov, seed):
    """Outputs of a CircuitBreaker over a seeded script of calls at
    increasing injected times."""
    rng = np.random.default_rng(seed)
    br = ov.CircuitBreaker(ov.BreakerPolicy(k_failures=3, window_s=1.0,
                                            cooldown_s=0.5), name="b")
    t, log = 0.0, []
    for op in rng.integers(0, 4, 300):
        t += float(rng.choice([0.01, 0.05, 0.2, 0.6]))
        if op == 0:
            out = br.allow(t)
        elif op == 1:
            out = br.record_failure(t)
        elif op == 2:
            out = br.record_success(t)
        else:
            out = br.retry_after(t)
        log.append((op, out, br.state, br.n_trips))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_breaker_matches_reference(seed):
    assert _breaker_log(OV, seed) == _breaker_log(ROV, seed)


def _error_tuple(err):
    return None if err is None else (err.code, err.message, err.detail,
                                     err.retry_after_s)


def _controller_log(ov, obs_pkg, seed):
    """One seeded script of completions, failures, latencies, backlog
    pins and ticks through an OverloadController over a fake scheduler:
    after every step the controller's estimates, level, knobs and the
    admission decisions it would take; then stats(), the recorder's
    incident reasons and the registry's Prometheus text."""
    rng = np.random.default_rng(seed)
    sched = _FakeSched(max_backlog=10, max_wait_s=0.2, pipeline_depth=2,
                       obs_pkg=obs_pkg)
    now = [0.0]
    ctrl = ov.OverloadController(ov.OverloadPolicy(
        slo=ov.ServeSLO(deadline_headroom_s=0.1), tick_s=0.01,
        ewma_alpha=0.5,
        breaker=ov.BreakerPolicy(k_failures=3, window_s=1.0, cooldown_s=0.5),
        brownout=ov.BrownoutPolicy(escalate_after_s=0.5, recover_after_s=1.0,
                                   wait_shrink=0.5, depth_cap=1,
                                   shed_below_priority=1)),
        clock=lambda: now[0])
    ctrl.bind(sched)
    log = []
    for op in rng.integers(0, 5, 240):
        now[0] += float(rng.choice([0.02, 0.1, 0.3, 0.7]))
        cap = int(rng.choice([64, 128]))
        if op == 0:
            ctrl.record_dispatch_success(cap, int(rng.integers(1, 8)))
        elif op == 1:
            ctrl.record_dispatch_failure(cap)
        elif op == 2:
            sched._outstanding[cap] = int(rng.integers(0, 12))
        elif op == 3:
            sched._h_latency.observe(float(rng.uniform(0.0, 0.5)))
        else:
            ctrl.tick(now[0])
        decisions = [_error_tuple(ctrl.check_admission_locked(
            c, outstanding=o, priority=p))
            for c in (64, 128) for o in (0, 5) for p in (0, 1)]
        log.append((op, ctrl.level, ctrl.n_transitions, sched.max_wait_s,
                    sched.pipeline_depth,
                    [(ctrl.service_rate(c), ctrl.effective_backlog(c))
                     for c in (64, 128)],
                    ctrl.retry_after_hint(), decisions))
    ctrl.close()
    return (log, ctrl.stats(),
            [d["reason"] for d in sched.obs.recorder.dumps],
            obs_pkg.prometheus_text(sched.obs.registry))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_matches_reference(seed):
    got = _controller_log(OV, TObs, seed)
    want = _controller_log(ROV, RefObs, seed)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    # the script reached the paths it is meant to compare
    assert any(step[1] for step in want[0])            # a brownout level
    assert any(d is not None and "circuit breaker" in d[1]
               for step in want[0] for d in step[7])


# ---------------------------------------------------------------------------
# scheduler integration (engine)
# ---------------------------------------------------------------------------

def _backoff_total(engine, seed):
    plan = FaultPlan(poison_rids=frozenset({0}))
    sched = ServeScheduler(engine, max_batch=2, fault_plan=plan,
                           retry_backoff_s=0.001, retry_backoff_seed=seed)
    rids = [sched.submit(*_scene(s, 40)) for s in range(2)]
    sched.flush()
    out = sched.take(rids)
    st = sched.stats()
    sched.close()
    assert out[rids[0]].error is not None           # the poisoned rid
    assert st["faults"]["retries"] > 0
    return st["faults"]["retry_backoff_s"]


def test_seeded_backoff_determinism(engine):
    a = _backoff_total(engine, 123)
    b = _backoff_total(engine, 123)
    c = _backoff_total(engine, 321)
    assert a > 0
    assert a == b
    assert a != c


def test_priority_lanes_edf_order(engine):
    """With the controller attached, full batches defer while the bucket
    is at pipeline depth; flush() pops the deferred queue highest priority
    first, earliest deadline first within a priority.  Checked on the
    recorder's dispatch order and rids, and every scene's labels against
    `segment` (no deadline flush, no watchdog: nothing depends on time)."""
    scenes = [_scene(100 + s, 40) for s in range(10)]
    obs = Observability.enabled()
    pol = OverloadPolicy(
        tick_s=10.0,  # keep the estimator/ladder quiet for this test
        brownout=BrownoutPolicy(escalate_after_s=60.0))
    sched = ServeScheduler(engine, max_batch=2, pipeline_depth=1,
                           overload=pol, watchdog_s=0, obs=obs,
                           instance="lane")
    # 2 batches dispatch at once (fill the depth), the rest defer; within
    # priority 1 the earlier deadline goes first
    prios = [0, 0, 0, 0, 0, 0, 5, 5, 1, 1]
    deadlines = [None] * 8 + [60.0, 30.0]
    rids = [sched.submit(*sc, priority=p, deadline_s=d)
            for sc, p, d in zip(scenes, prios, deadlines)]
    st = sched.stats()
    assert st["queue_depth"] == 6 and st["in_flight"] == 2
    sched.flush()
    out = sched.take(rids)
    sched.close()
    order = [tuple(e["rids"]) for e in obs.recorder.events()
             if e["type"] == "dispatch"]
    assert order == [(rids[0], rids[1]), (rids[2], rids[3]),
                     (rids[6], rids[7]), (rids[8], rids[9]),
                     (rids[4], rids[5])]
    for rid, (c, f, m) in zip(rids, scenes):
        assert out[rid].ok
        np.testing.assert_array_equal(out[rid].preds, seg_preds(c, m, f))


def test_controller_off_bit_identity(engine):
    scenes = [_scene(200 + s, 50) for s in range(4)]
    outs = []
    for overload in (None, True):
        sched = ServeScheduler(engine, max_batch=2, overload=overload)
        assert (sched.overload is None) == (overload is None)
        rids = [sched.submit(*sc) for sc in scenes]
        sched.flush()
        out = sched.take(rids)
        sched.close()
        outs.append([out[r].preds for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_scheduler_timeout_carries_retry_hint(engine):
    sched = ServeScheduler(engine, max_batch=4, overload=True,
                           watchdog_s=0)
    rid = sched.submit(*_scene(300, 40), deadline_s=0.0)
    sched.flush()
    out = sched.take([rid])
    assert sched.service_rate(64) is None
    assert sched.retry_after_hint() is not None
    sched.close()
    assert out[rid].error.code == FLT.TIMEOUT
    assert out[rid].error.retry_after_s is not None
    assert out[rid].error.retry_after_s >= 0.0


def test_stats_surface_unified_backlog_names(engine):
    sched = ServeScheduler(engine, max_batch=2, max_backlog=6)
    st = sched.stats()
    assert sched.service_rate(64) is None
    assert sched.retry_after_hint() is None
    sched.close()
    assert st["scheduler_max_backlog"] == 6
    assert "scheduler_max_backlog" in MX.SCHEDULER_STATS_KEYS
    assert "router_max_backlog" in MX.ROUTER_STATS_KEYS


def test_storm_conservation_and_bit_identity(engine):
    """3 producers at ~4x the storm-paced capacity: every submit is
    conserved across ok/rejected/shed/timeout/exec_failed, nothing
    exec-fails, sheds carry retry_after_s, every trace closes, and the
    survivors' labels equal `segment`'s."""
    n_producers, per_producer = 3, 12
    scenes = {(k, j): _scene(400 + k * per_producer + j, 40)
              for k in range(n_producers) for j in range(per_producer)}
    # 15 dispatches/s of 2 scenes (~30 scenes/s) against ~120 scenes/s
    # offered: the reference's 2x leaves the shed to timing on a CPU
    plan = FaultPlan(storm_buckets={64: 15.0})
    obs = Observability.enabled()
    sched = ServeScheduler(
        engine, max_batch=2, pipeline_depth=2, max_backlog=8,
        max_wait_s=0.05, fault_plan=plan, obs=obs, instance="storm",
        overload=OverloadPolicy(slo=ServeSLO(deadline_headroom_s=0.2),
                                tick_s=0.02))
    rids: dict = {}
    lock = threading.Lock()
    errs: list = []

    def producer(k):
        try:
            for j in range(per_producer):
                rid = sched.submit(*scenes[(k, j)], deadline_s=1.0,
                                   priority=k)
                with lock:
                    rids[(k, j)] = rid
                time.sleep(0.025)
        except Exception as e:              # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(n_producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    sched.flush()
    out = sched.take(list(rids.values()))
    st = sched.stats()
    sched.close()

    n_total = n_producers * per_producer
    ft = st["faults"]
    assert len(out) == n_total
    assert st["n_submitted"] == n_total
    assert st["n_completed"] == n_total
    assert st["n_submitted"] == (st["n_ok"] + ft["rejected"] + ft["shed"]
                                 + ft["timeout"] + ft["exec_failed"])
    assert ft["exec_failed"] == 0
    assert ft["shed"] >= 1
    shed_hints = [r.error.retry_after_s for r in out.values()
                  if r.error is not None and r.error.code == FLT.SHED]
    assert shed_hints and all(h is not None and h >= 0
                              for h in shed_hints)
    assert obs.tracer.stats()["live"] == 0
    n_checked = 0
    for kj, rid in rids.items():
        if out[rid].ok:
            c, f, m = scenes[kj]
            np.testing.assert_array_equal(out[rid].preds,
                                          seg_preds(c, m, f))
            n_checked += 1
    assert n_checked == st["n_ok"] and n_checked >= 1
