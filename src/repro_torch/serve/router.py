"""Multi-worker serving fabric: a digest-affinity router over a pool of
`ServeScheduler` workers.

One pipelined `ServeScheduler` maxes out a single engine; the "millions
of users" jump is a front-end `ServeRouter` that fans a request stream
out over N workers — each owning its OWN `PointCloudEngine` (private
`MappingCache` and `AssemblyCache`) and its own scheduler — while keeping
the cached-geometry hot path hot:

  * **digest affinity** — every admitted scene is hashed once
    (`PointCloudEngine.scene_key` over the bucket-padded geometry — the
    same digest the worker's scheduler uses for its mapping/assembly
    cache keys) and routed by *rendezvous hashing* (highest-random-
    weight) over the live workers.  Identical geometry therefore keeps
    landing on the worker that already holds its `MappingCache` /
    `AssemblyCache` entries, and when the pool changes only the keys
    that hashed to the departed/joined worker move — every other
    geometry keeps its warm worker;
  * **health-checked failover** — each worker thread beats a
    `launch.fault_tolerance.Pulse` every loop iteration; a background
    `Ticker` (and every blocking router call) runs the health check: a
    worker whose thread died is failed over immediately, and a worker
    whose pulse has gone stale past the `LivenessPolicy` (missed beats —
    a hung dispatch, a wedged device) is declared dead without waiting
    for it;
  * **in-flight replay** — failing a worker over first *salvages* any
    results already completed inside its scheduler (non-blocking poll),
    then REPLAYS everything still queued or in flight on it onto the
    surviving workers, re-routed by the same rendezvous ranking minus
    the dead worker.  Per-request replay attempts are bounded
    (`max_replays`, the router-level analogue of the scheduler's
    `max_retries`); exhaustion completes the request with the same typed
    `exec_failed` taxonomy as the scheduler's retries.  Replayed scenes
    re-run the same deterministic model, so survivors stay bit-identical
    to a no-fault run.  A late result from a worker that woke up after
    being declared dead is discarded by an ownership check — a request
    completes exactly once;
  * **elastic pool** — `add_worker()` joins a fresh worker (immediately
    rendezvous-eligible: only the keys that rank it first move);
    `remove_worker()` drains-then-leaves: the worker stops receiving new
    routes, finishes its outstanding work, then its scheduler closes and
    the thread joins;
  * **graceful degradation** — a submit with zero live workers, or with
    every live worker at its `max_backlog` outstanding bound, completes
    with a typed `shed` result instead of raising or queueing unbounded;
    replay with no survivors sheds the same way.  The stream keeps
    flowing at whatever capacity remains;
  * **aggregate telemetry** — `stats()` rolls the pool up (per-worker
    state / occupancy / cache rates + pooled totals, failovers, replayed
    requests, failure→recovered time) and nests each worker's full
    scheduler stats.

Worker chaos (`serve.faults.FaultPlan.kill_workers` / `hang_workers`)
threads through the worker-loop seam, so the failover and replay paths
are deterministic to test — and with one worker and no faults the router
is bit-identical to its bare scheduler.

On one card every worker's engine lives on the same device (built by
`PointCloudEngine.factory`, sharing the weights); each worker thread
dispatches through its own scheduler, which runs under
`torch.cuda.device(engine.device)` on that thread's current stream.  The
router itself holds no tensors and launches nothing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from repro_torch.api import MappingCache
from repro_torch.launch import fault_tolerance as FT
from repro_torch.obs import Observability
from repro_torch.serve import buckets as BK
from repro_torch.serve import faults as FLT
from repro_torch.serve import overload as OV
from repro_torch.serve.faults import ServeError
from repro_torch.serve.scheduler import ServeResult, ServeScheduler

DEFAULT_MAX_REPLAYS = 2
# settle loops wake on every completion (condition notify); the timeout
# is only the fallback cadence for health checks / flush nudges while
# nothing completes, so it can be coarse without adding latency
_SETTLE_WAIT_S = 0.05

LIVE = "live"
DRAINING = "draining"
DEAD = "dead"
LEFT = "left"


@dataclasses.dataclass(frozen=True)
class LivenessPolicy:
    """When is a worker dead?

    beat_s     : target heartbeat cadence — the worker loop beats at
                 least this often while healthy (its idle wait is
                 beat_s / 2).
    miss_beats : a worker whose pulse is older than beat_s * miss_beats
                 is declared hung and failed over.  The default budget
                 (30s) is deliberately generous: a worker blocks its
                 loop for a full device wait — including a first use
                 that builds the kernels with nvcc and allocates device
                 and pinned memory, easily 10s+ — and a false
                 hang verdict costs a full replay.  `router.liveness`
                 is read live, so chaos tests (and latency-sensitive
                 deployments) warm the pool under the default policy,
                 then assign a tight one.
    health_s   : background health-check interval (None = beat_s).  The
                 check also runs inline in every blocking router call,
                 so failover latency is bounded by min(health_s,
                 caller's wait) even without the ticker.
    """

    beat_s: float = 0.25
    miss_beats: int = 120
    health_s: float | None = None

    def __post_init__(self):
        if self.beat_s <= 0 or self.miss_beats < 1:
            raise ValueError(
                f"LivenessPolicy needs beat_s > 0 and miss_beats >= 1, "
                f"got beat_s={self.beat_s}, miss_beats={self.miss_beats}")

    @property
    def stall_s(self) -> float:
        return self.beat_s * self.miss_beats


@dataclasses.dataclass
class _Routed:
    """Router-side record of one admitted request: everything needed to
    replay it on another worker if its current owner dies."""

    rrid: int
    key: bytes                  # rendezvous salt (geometry digest)
    coords: object
    feats: object
    mask: object
    n_points: int
    deadline: float | None      # absolute monotonic deadline (router)
    t_submit: float
    worker: "_Worker"
    attempts: int = 0           # completed-worker losses survived
    priority: int = 0           # lane (forwarded to the worker scheduler)


class _Worker:
    """One serving worker: a thread owning a private engine + scheduler.

    The router enqueues `(rrid, scene)` items into the worker's inbox;
    the loop admits them into the scheduler, publishes completed results
    back to the router (translating scheduler-local rids to router
    rids), and beats its `Pulse` every iteration so the router's
    liveness policy can tell a busy worker from a dead one.  All
    *blocking* work (scheduler flush — device waits included) happens on
    this thread, never on a router caller's, which is what makes a hung
    dispatch detectable and survivable.
    """

    def __init__(self, router: "ServeRouter", name: str, ordinal: int,
                 engine, sched_kwargs: dict):
        self.router = router
        self.name = name
        self.ordinal = ordinal
        self.engine = engine
        self.sched = ServeScheduler(engine, **sched_kwargs)
        self.pulse = FT.Pulse()
        self.state = LIVE
        self.cv = threading.Condition()
        self.inbox: deque = deque()
        self.local_rrid: dict[int, int] = {}   # scheduler rid -> router rid
        self.crash: BaseException | None = None
        self.reason: str | None = None
        self.n_processed = 0    # items admitted into the scheduler
        self.n_routed = 0       # items ever routed here (telemetry)
        self.assigned = 0       # incomplete router requests owned here
        self._flush_req = False
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"serve-worker-{name}")
        self.thread.start()

    # -- router-side controls (called under the router lock) ---------------

    def enqueue(self, item) -> None:
        with self.cv:
            self.inbox.append(item)
            self.n_routed += 1
            self.cv.notify()

    def request_flush(self) -> None:
        with self.cv:
            self._flush_req = True
            self.cv.notify()

    def request_stop(self) -> None:
        with self.cv:
            self._stop = True
            self.cv.notify()

    def abandon(self) -> list:
        """Fail-over teardown: stop the thread (it may be hung — not
        joined here), clear the inbox, and hand the un-admitted items
        back for replay."""
        with self.cv:
            self._stop = True
            orphans = list(self.inbox)
            self.inbox.clear()
            self.cv.notify()
        return orphans

    def idle(self) -> bool:
        with self.cv:
            return not self.inbox and not self._flush_req

    def harvest(self) -> list:
        """Non-blocking: pop results already completed inside the
        scheduler, translated to (router_rid, ServeResult) pairs.  Used
        by the worker loop to publish, and by the router to salvage a
        dead worker's finished work before replaying the rest."""
        results = self.sched.poll()
        if not results:
            return []
        with self.cv:
            pairs = [(self.local_rrid.pop(r.rid, None), r)
                     for r in results]
        return [(rrid, r) for rrid, r in pairs if rrid is not None]

    # -- the worker loop ---------------------------------------------------

    def _publish(self) -> None:
        pairs = self.harvest()
        if pairs:
            self.router._absorb(self, pairs)

    def _run(self) -> None:
        try:
            while True:
                beat_s = self.router.liveness.beat_s   # read live
                with self.cv:
                    if self._stop and not self.inbox \
                            and not self._flush_req:
                        break
                    has_work = bool(self.inbox) or self._flush_req
                    if not has_work:
                        self.cv.wait(beat_s / 2)
                        has_work = bool(self.inbox) or self._flush_req
                self.pulse.beat()
                if has_work:
                    plan = self.router.fault_plan
                    if plan is not None:
                        # chaos seam: a planned hang stops the beat (the
                        # liveness policy must catch it); a planned kill
                        # raises and crashes this thread with the popped
                        # item still safely in the inbox
                        plan.on_worker_step(self.ordinal,
                                            self.n_processed)
                    with self.cv:
                        item = self.inbox.popleft() if self.inbox \
                            else None
                        flush = self._flush_req if item is None else False
                    if item is not None:
                        (rrid, coords, feats, mask, deadline, priority,
                         tid) = item
                        remaining = None if deadline is None else \
                            max(0.0, deadline - time.monotonic())
                        local = self.sched.submit(coords, feats, mask,
                                                  deadline_s=remaining,
                                                  priority=priority,
                                                  trace_id=tid)
                        with self.cv:
                            self.local_rrid[local] = rrid
                        self.n_processed += 1
                    elif flush:
                        # blocking device waits live HERE, on the worker
                        # thread — a wedged wait stalls the pulse, not
                        # the router
                        self.sched.flush()
                        self._publish()
                        with self.cv:
                            self._flush_req = False
                        self.router._notify_done()
                self._publish()
        except BaseException as e:   # noqa: BLE001 — injected kills too
            self.crash = e
            try:
                self._publish()
            except Exception:
                pass


def _rendezvous_score(key: bytes, name: str) -> int:
    """Highest-random-weight score of (geometry key, worker name): each
    key ranks every worker deterministically, and removing a worker
    reassigns ONLY the keys that ranked it first."""
    h = hashlib.blake2b(key, digest_size=8, person=b"serve-rdzv",
                        salt=hashlib.blake2b(
                            name.encode(), digest_size=16).digest())
    return int.from_bytes(h.digest(), "big")


class ServeRouter:
    """Digest-affinity front end over a pool of `ServeScheduler` workers.

    engine_factory   : zero-arg callable building one `PointCloudEngine`
                       per worker (same params/config — predictions must
                       be worker-independent; see
                       `PointCloudEngine.factory`).
    n_workers        : initial pool size (>= 1; the pool can shrink to
                       zero later — submits then shed).
    liveness         : `LivenessPolicy` (heartbeat cadence, missed-beat
                       budget, health-check interval).
    max_replays      : worker losses one request survives before it
                       completes `exec_failed` (the router-level
                       analogue of the scheduler's `max_retries`).
    max_backlog      : PER-WORKER bound on outstanding (routed,
                       incomplete) requests — scenes assigned to one
                       worker across all of its buckets; a submit
                       finding every live worker at the bound completes
                       with a `shed` result.  None = unbounded.  (The
                       scheduler's same-named knob is PER-BUCKET;
                       `stats()` surfaces this one as
                       `router_max_backlog`.)
    overload         : `overload.OverloadPolicy` (or True for the
                       defaults) — every worker's scheduler builds its
                       own `OverloadController` from it (adaptive
                       shedding, priority lanes, bucket breakers,
                       brownout), and the router adds PER-WORKER
                       circuit breakers: a worker producing
                       `exec_failed` results trips its breaker and the
                       rendezvous ranking routes around it until a
                       half-open probe succeeds.  Shed results carry an
                       aggregated `retry_after_s` hint (the minimum
                       over the live workers' drain estimates).  None
                       (default) keeps routing bit-identical to the
                       uncontrolled router.
    fault_plan       : `serve.faults.FaultPlan` chaos seam — worker
                       kills/hangs fire in the worker loops; the
                       scheduler-level seams (dispatch failures, bucket
                       delays, poisons) are threaded into every worker's
                       scheduler (note: per-scheduler dispatch ordinals,
                       so `fail_dispatches={0}` fails dispatch 0 of
                       EVERY worker).
    scheduler_kwargs : forwarded to each worker's `ServeScheduler`
                       (max_batch, pipeline_depth, max_wait_s, ...).

    `submit`/`poll`/`flush`/`drain`/`take`/`serve` mirror the scheduler's
    surface and contract: thread-safe, and no per-request problem ever
    raises — every request completes with predictions or a typed
    `ServeResult.error`.  Request ids are router-level (worker-local rids
    never escape).
    """

    def __init__(self, engine_factory, n_workers: int = 2, *,
                 liveness: LivenessPolicy | None = None,
                 max_replays: int = DEFAULT_MAX_REPLAYS,
                 max_backlog: int | None = None,
                 overload=None,
                 fault_plan: FLT.FaultPlan | None = None,
                 obs: Observability | None = None,
                 **scheduler_kwargs):
        if n_workers < 1:
            raise ValueError("ServeRouter needs n_workers >= 1 to start "
                             "(the pool may shrink to zero later)")
        if max_replays < 0:
            raise ValueError("max_replays must be >= 0")
        if max_backlog is not None and max_backlog < 1:
            raise ValueError("max_backlog must be >= 1 (or None)")
        if overload is True:
            overload = OV.OverloadPolicy()
        if overload is not None and \
                not isinstance(overload, OV.OverloadPolicy):
            raise TypeError(
                "ServeRouter overload= takes None/True/OverloadPolicy "
                "(each worker scheduler builds its own controller)")
        self.engine_factory = engine_factory
        self.liveness = liveness if liveness is not None \
            else LivenessPolicy()
        self.max_replays = int(max_replays)
        self.max_backlog = max_backlog
        self.overload = overload
        self.fault_plan = fault_plan
        self._sched_kwargs = dict(scheduler_kwargs)
        self._sched_kwargs.setdefault("fault_plan", fault_plan)
        if overload is not None:
            self._sched_kwargs.setdefault("overload", overload)

        self._lock = threading.RLock()
        self._done = threading.Condition(self._lock)
        self._workers: OrderedDict[str, _Worker] = OrderedDict()
        self._next_ordinal = 0
        self._next_rrid = 0
        self._routed: dict[int, _Routed] = {}
        self._completed: OrderedDict[int, ServeResult] = OrderedDict()
        self._closed = False
        # telemetry: registry children shared with every worker's
        # scheduler (the workers bind their own `instance` labels);
        # tracer/recorder are optional — the same bundle reaches the
        # workers, so one trace tree spans route -> worker -> failover
        # replay on a survivor
        self.obs = obs if obs is not None else Observability()
        self._tracer = self.obs.tracer
        self._recorder = self.obs.recorder
        reg = self.obs.registry
        inst = "router"
        self._c_submitted = reg.counter(
            "serve_requests_submitted_total",
            "scenes admitted via submit()", ("instance",)).labels(inst)
        self._c_completed = reg.counter(
            "serve_requests_completed_total",
            "requests completed (ok or typed error)",
            ("instance",)).labels(inst)
        self._c_ok = reg.counter(
            "serve_requests_ok_total",
            "requests completed with predictions", ("instance",)).labels(inst)
        fam_faults = reg.counter(
            "serve_faults_total", "typed error results by code",
            ("instance", "code"))
        self._c_faults = {c: fam_faults.labels(inst, c)
                          for c in FLT.ERROR_CODES}
        self._c_failovers = reg.counter(
            "serve_failovers_total", "workers declared dead",
            ("instance",)).labels(inst)
        self._c_replays = reg.counter(
            "serve_replays_total",
            "requests replayed onto surviving workers",
            ("instance",)).labels(inst)
        self._h_latency = reg.histogram(
            "serve_request_latency_seconds",
            "submit -> predictions (OK results only)",
            ("instance",)).labels(inst)
        fam_errlat = reg.histogram(
            "serve_error_latency_seconds",
            "submit -> typed error result, by code", ("instance", "code"))
        self._h_errlat = {c: fam_errlat.labels(inst, c)
                          for c in FLT.ERROR_CODES}
        self._g_recovery = reg.gauge(
            "serve_recovery_seconds",
            "failover -> last victim resolved", ("instance",)).labels(inst)
        self._recovering: set[int] = set()
        self._t_failover: float | None = None
        # per-worker circuit breakers (overload control only — the
        # disabled path registers nothing and routes identically)
        self._breakers: dict[str, OV.CircuitBreaker] = {}
        self._fam_breaker = reg.gauge(
            "serve_breaker_state",
            "circuit breaker state (0 closed / 1 half-open / 2 open)",
            ("instance", "target")) if self.overload is not None else None

        for _ in range(n_workers):
            self._add_worker_locked()
        self.ladder = next(iter(self._workers.values())).engine.ladder
        health_s = self.liveness.health_s \
            if self.liveness.health_s is not None else self.liveness.beat_s
        self._health = FT.Ticker(health_s, self._health_tick,
                                 name="serve-router-health")

    # -- pool management ---------------------------------------------------

    def _add_worker_locked(self, name: str | None = None) -> "_Worker":
        ordinal = self._next_ordinal
        self._next_ordinal += 1
        name = name if name is not None else f"w{ordinal}"
        if name in self._workers:
            raise ValueError(f"worker {name!r} already exists")
        w = _Worker(self, name, ordinal, self.engine_factory(),
                    dict(self._sched_kwargs, obs=self.obs, instance=name))
        self._workers[name] = w
        if self.overload is not None:
            self._breakers[name] = OV.CircuitBreaker(
                self.overload.breaker, name=f"worker:{name}",
                gauge=self._fam_breaker.labels("router", f"worker:{name}"))
        return w

    def add_worker(self, name: str | None = None) -> str:
        """Join a fresh worker (own engine + scheduler + thread) to the
        pool; it is rendezvous-eligible immediately, so exactly the keys
        that rank it first start landing on it.  Returns the worker
        name."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            return self._add_worker_locked(name).name

    def remove_worker(self, name: str, timeout_s: float = 60.0) -> None:
        """Drain-then-leave: the worker stops receiving new routes, its
        outstanding requests complete (or fail over if it dies while
        draining), then its scheduler closes and the thread joins.
        Digest re-affinity is automatic — only the keys that ranked the
        departed worker first move, each to its next-ranked survivor."""
        with self._lock:
            w = self._workers.get(name)
            if w is None:
                raise KeyError(f"no worker named {name!r}")
            if w.state != LIVE:
                raise ValueError(f"worker {name!r} is {w.state}, "
                                 f"not live")
            w.state = DRAINING
        self._settle(lambda: w.assigned == 0 or w.state != DRAINING,
                     timeout_s)
        with self._lock:
            if w.state != DRAINING:     # died mid-drain: already handled
                return
            w.request_stop()
        w.thread.join(timeout_s)
        try:
            w.sched.close()
        except Exception:
            pass
        with self._lock:
            if w.state == DRAINING:
                w.state = LEFT

    def workers(self) -> dict[str, str]:
        """{name: state} snapshot of the pool."""
        with self._lock:
            return {name: w.state for name, w in self._workers.items()}

    # -- routing -----------------------------------------------------------

    def _affinity_key(self, coords, mask):
        """The geometry digest identical geometry always maps to: the
        scene padded to its ladder bucket, hashed exactly like the
        worker scheduler's mapping-cache key — so affinity routing and
        worker-local caching agree byte for byte.  Falls back to None
        (rrid-salted routing) for scenes admission will reject anyway."""
        try:
            coords = np.asarray(coords)
            n = coords.shape[0]
            mask = np.ones(n, bool) if mask is None \
                else np.asarray(mask, bool)
            cap = self.ladder.bucket_for(n)
            c, m, _ = BK.pad_scene(coords, mask, None, cap)
            return MappingCache.digest((c, m), extra=("levels", cap))
        except Exception:
            return None

    def _route_locked(self, key: bytes) -> "_Worker | None":
        """Rendezvous-ranked live worker with backlog headroom and a
        non-open circuit breaker, else None (no live workers, every one
        saturated, or every one circuit-broken).  The backlog check runs
        BEFORE the breaker check so a saturated worker never consumes a
        half-open probe slot it cannot serve."""
        live = [w for w in self._workers.values() if w.state == LIVE]
        if not live:
            return None
        ranked = sorted(live,
                        key=lambda w: _rendezvous_score(key, w.name),
                        reverse=True)
        for w in ranked:
            if self.max_backlog is not None and \
                    w.assigned >= self.max_backlog:
                continue
            br = self._breakers.get(w.name)
            if br is not None and br.state != OV.CLOSED \
                    and not br.allow():
                continue
            return w
        return None

    def preview(self, coords, mask=None) -> str | None:
        """The live worker this geometry would route to right now (None
        for a scene admission would reject, or an empty/saturated pool)
        — affinity introspection for tests, chaos targeting, and
        capacity planning.  Pure: nothing is enqueued."""
        key = self._affinity_key(coords, mask)
        if key is None:
            return None
        with self._lock:
            w = self._route_locked(key)
            return w.name if w is not None else None

    def _retry_hint_locked(self) -> float | None:
        """Aggregated backpressure hint for a pool-level shed: the
        minimum over the live workers' drain estimates (the first
        worker to free up is when a resubmit can land) and any tripped
        breaker's next probe slot.  None without overload control."""
        if self.overload is None:
            return None
        hints = []
        for w in self._workers.values():
            if w.state != LIVE:
                continue
            h = w.sched.retry_after_hint()
            if h is not None:
                hints.append(h)
            br = self._breakers.get(w.name)
            if br is not None and br.state != OV.CLOSED:
                hints.append(br.retry_after())
        return min(hints) if hints else \
            self.overload.slo.deadline_headroom_s

    def submit(self, coords, feats, mask=None,
               deadline_s: float | None = None,
               priority: int = 0) -> int:
        """Admit one scene; returns its router request id — ALWAYS.

        The scene is digested and rendezvous-routed to its affinity
        worker (falling past saturated or circuit-broken workers to the
        next-ranked one); a pool with zero live workers, or every
        worker at `max_backlog` / circuit-broken, completes the request
        with a `shed` result (carrying an aggregated `retry_after_s`
        hint under overload control).  Validation itself happens in the
        worker's scheduler — malformed scenes come back as `rejected`
        results exactly as on the bare scheduler.  `priority` rides
        along to the worker scheduler's lane ordering."""
        t_submit = time.monotonic()
        key = self._affinity_key(coords, mask)
        try:
            n_points = int(np.asarray(coords).shape[0])
        except Exception:
            n_points = 0
        with self._lock:
            rrid = self._next_rrid
            self._next_rrid += 1
            self._c_submitted.inc()
            tid = None
            if self._tracer is not None:
                tid = f"router:rrid:{rrid}"
                self._tracer.begin(tid, t=t_submit, rrid=rrid,
                                   instance="router")
            if self._closed:
                self._complete_error_locked(
                    rrid, n_points, t_submit,
                    ServeError(FLT.REJECTED, "router is closed"))
                return rrid
            salt = key if key is not None else f"rrid:{rrid}".encode()
            w = self._route_locked(salt)
            if w is None:
                live = [x for x in self._workers.values()
                        if x.state == LIVE]
                broken = sum(1 for x in live
                             if self._breakers.get(x.name) is not None
                             and self._breakers[x.name].state != OV.CLOSED)
                if not live:
                    msg = "no live workers in the pool"
                elif broken and self.overload is not None:
                    backlogs = [x.assigned for x in live]
                    msg = (f"all {len(live)} live workers unavailable: "
                           f"{broken} circuit-broken, backlogs "
                           f"{backlogs} vs the max_backlog bound "
                           f"({self.max_backlog} outstanding per worker)")
                else:
                    msg = (f"all {len(live)} live workers at the "
                           f"max_backlog bound ({self.max_backlog} "
                           f"outstanding)")
                self._complete_error_locked(
                    rrid, n_points, t_submit,
                    ServeError(FLT.SHED, msg,
                               retry_after_s=self._retry_hint_locked()))
                return rrid
            deadline = t_submit + deadline_s \
                if deadline_s is not None else None
            routed = _Routed(rrid, salt, coords, feats, mask, n_points,
                             deadline, t_submit, w, priority=int(priority))
            self._routed[rrid] = routed
            if self._tracer is not None:
                self._tracer.span(tid, "route", t_start=t_submit,
                                  t_end=time.monotonic(), worker=w.name)
            w.assigned += 1
            w.enqueue((rrid, coords, feats, mask, deadline,
                       int(priority), tid))
            return rrid

    # -- completion --------------------------------------------------------

    def _complete_locked(self, routed: _Routed,
                         result: ServeResult) -> None:
        routed.worker.assigned -= 1
        del self._routed[routed.rrid]
        self._completed[routed.rrid] = result
        self._c_completed.inc()
        if result.error is None:
            self._c_ok.inc()
            self._h_latency.observe(result.latency_s)
        else:
            self._c_faults[result.error.code].inc()
            self._h_errlat[result.error.code].observe(result.latency_s)
        if self._tracer is not None:
            self._tracer.end(
                f"router:rrid:{routed.rrid}",
                outcome="ok" if result.error is None
                else result.error.code)
        if self._recovering:
            self._recovering.discard(routed.rrid)
            if not self._recovering and self._t_failover is not None:
                self._g_recovery.set(time.monotonic() - self._t_failover)
                self._t_failover = None
        self._done.notify_all()

    def _complete_error_locked(self, rrid: int, n_points: int,
                               t_submit: float, err: ServeError) -> None:
        """Terminate a request the router itself refuses (shed / closed
        / replay exhaustion) — same result shape as the scheduler's.
        The wait lands in the per-code error histogram (error-path
        latency used to vanish from the ok-only average)."""
        lat = time.monotonic() - t_submit
        self._completed[rrid] = ServeResult(
            rrid, None, int(n_points), -1, 0.0, False, lat, err)
        self._c_completed.inc()
        self._c_faults[err.code].inc()
        self._h_errlat[err.code].observe(lat)
        if self._tracer is not None:
            tid = f"router:rrid:{rrid}"
            self._tracer.event(tid, "error", code=err.code,
                               message=err.message)
            self._tracer.end(tid, outcome=err.code)
        if self._recovering:
            self._recovering.discard(rrid)
            if not self._recovering and self._t_failover is not None:
                self._g_recovery.set(time.monotonic() - self._t_failover)
                self._t_failover = None
        self._done.notify_all()

    def _absorb(self, w: "_Worker", pairs) -> None:
        """Accept (router_rid, worker ServeResult) pairs from a worker.
        Ownership-checked: a result for a request that already completed
        or was replayed onto another worker is discarded — each request
        completes exactly once, from its current owner."""
        with self._lock:
            now = time.monotonic()
            br = self._breakers.get(w.name)
            for rrid, res in pairs:
                routed = self._routed.get(rrid)
                if routed is None or routed.worker is not w:
                    continue            # stale: replayed or completed
                if br is not None:
                    # exec_failed results count toward the worker's
                    # breaker window; ok results close a half-open
                    # probe (shed/timeout are load signals, not worker
                    # failures — they count toward neither)
                    if res.error is not None and \
                            res.error.code == FLT.EXEC_FAILED:
                        if br.record_failure(now) and \
                                self._recorder is not None:
                            self._recorder.record(
                                "breaker_trip", target=f"worker:{w.name}",
                                state=br.state, trips=br.n_trips,
                                instance="router")
                            self._recorder.dump(
                                "breaker_trip",
                                key=("breaker", w.name, br.n_trips))
                    elif res.error is None:
                        br.record_success(now)
                self._complete_locked(routed, dataclasses.replace(
                    res, rid=rrid, latency_s=now - routed.t_submit))

    # -- health + failover -------------------------------------------------

    def _health_tick(self) -> None:
        with self._lock:
            self._health_tick_locked()

    def _health_tick_locked(self) -> None:
        stall = self.liveness.stall_s
        for w in list(self._workers.values()):
            if w.state not in (LIVE, DRAINING):
                continue
            if not w.thread.is_alive():
                self._fail_worker_locked(
                    w, f"worker thread crashed: {w.crash!r}")
            elif w.pulse.stalled(stall):
                self._fail_worker_locked(
                    w, f"hung: no heartbeat for {w.pulse.age():.2f}s "
                       f"(stall budget {stall:.2f}s)")

    def _fail_worker_locked(self, w: "_Worker", reason: str) -> None:
        """Declare one worker dead and make its work whole: salvage
        results its scheduler already finished, then replay everything
        still queued or in flight onto the surviving workers (bounded by
        `max_replays` per request; exhaustion and empty pools complete
        the request with typed errors).  The dead worker's thread is
        told to stop but never joined here — it may be hung; a late
        result it publishes after waking is discarded by `_absorb`'s
        ownership check."""
        if w.state not in (LIVE, DRAINING):
            return
        w.state = DEAD
        w.reason = reason
        self._c_failovers.inc()
        t_death = time.monotonic()
        w.abandon()
        try:                            # non-blocking salvage
            self._absorb(w, w.harvest())
        except Exception:
            pass
        victims = [r for r in self._routed.values() if r.worker is w]
        if self._recorder is not None:
            self._recorder.record(
                "failover", worker=w.name, reason=reason,
                victims=[r.rrid for r in victims], instance="router")
            # one post-mortem snapshot per dead worker — ten stranded
            # requests still produce ONE dump
            self._recorder.dump("failover", key=("failover", w.name))
        if victims:
            self._recovering.update(r.rrid for r in victims)
            if self._t_failover is None:
                self._t_failover = t_death
        for r in victims:
            r.attempts += 1
            if self._tracer is not None:
                self._tracer.event(f"router:rrid:{r.rrid}", "failover",
                                   t=t_death, worker=w.name,
                                   reason=reason, attempts=r.attempts)
            if r.attempts > self.max_replays:
                self._complete_locked(r, ServeResult(
                    r.rrid, None, r.n_points, -1, 0.0, False,
                    time.monotonic() - r.t_submit,
                    ServeError(FLT.EXEC_FAILED,
                               f"lost {r.attempts}x to failed workers "
                               f"(last: {w.name} {reason}); replay "
                               f"budget exhausted")))
                continue
            nw = self._route_locked(r.key)
            if nw is None:
                self._complete_locked(r, ServeResult(
                    r.rrid, None, r.n_points, -1, 0.0, False,
                    time.monotonic() - r.t_submit,
                    ServeError(FLT.SHED,
                               f"no live workers to replay onto after "
                               f"{w.name} was lost ({reason})")))
                continue
            w.assigned -= 1
            nw.assigned += 1
            r.worker = nw
            self._c_replays.inc()
            tid = None
            if self._tracer is not None:
                tid = f"router:rrid:{r.rrid}"
                self._tracer.event(tid, "replay", worker=nw.name,
                                   attempts=r.attempts)
            if self._recorder is not None:
                self._recorder.record("replay", rrid=r.rrid,
                                      worker=nw.name, instance="router")
            nw.enqueue((r.rrid, r.coords, r.feats, r.mask, r.deadline,
                        r.priority, tid))

    # -- waiting helpers ---------------------------------------------------

    def _notify_done(self) -> None:
        """Wake settled waiters (called by workers on completions and
        finished flushes)."""
        with self._lock:
            self._done.notify_all()

    def _settle(self, done, timeout_s: float | None = None) -> None:
        """Run health checks + flush nudges until `done()` (checked
        under the lock) holds.  Blocking router calls funnel through
        here, so a worker dying mid-wait is failed over and replayed
        WHILE the caller waits — the wait converges instead of hanging
        on a dead worker.  Waits are completion-notified (zero added
        latency on the hot path); `_SETTLE_WAIT_S` only paces the
        health checks while nothing completes."""
        deadline = time.monotonic() + timeout_s \
            if timeout_s is not None else None
        while True:
            with self._lock:
                self._health_tick_locked()
                if done():
                    return
                for w in self._workers.values():
                    if w.state in (LIVE, DRAINING) and w.assigned > 0:
                        w.request_flush()
                self._done.wait(_SETTLE_WAIT_S)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    "router wait did not settle within "
                    f"{timeout_s}s")

    # -- serving surface (mirrors ServeScheduler) --------------------------

    def poll(self) -> list[ServeResult]:
        """Non-blocking tick: run the health check (failing over dead
        workers) and hand back everything completed so far."""
        with self._lock:
            self._health_tick_locked()
            out = list(self._completed.values())
            self._completed.clear()
            return out

    def flush(self) -> None:
        """Ask every live worker to execute its queued scenes (partial
        micro-batches dummy-fill) and wait for those flushes; a worker
        dying mid-flush is failed over and its work replayed."""
        with self._lock:
            targets = [w for w in self._workers.values()
                       if w.state in (LIVE, DRAINING)]
            for w in targets:
                w.request_flush()
        self._settle(lambda: all(
            w.state not in (LIVE, DRAINING) or w.idle()
            for w in targets))

    def drain(self) -> list[ServeResult]:
        """Complete every outstanding request (flushing and failing over
        as needed) and hand back all results, in completion order."""
        self._settle(lambda: not self._routed)
        with self._lock:
            out = list(self._completed.values())
            self._completed.clear()
            return out

    def take(self, rids) -> dict[int, ServeResult]:
        """Complete and pop results for `rids` only; other callers'
        results stay drainable."""
        want = [int(r) for r in rids]
        want_set = set(want)
        self._settle(lambda: not want_set.intersection(self._routed))
        with self._lock:
            return {r: self._completed.pop(r) for r in want
                    if r in self._completed}

    def serve(self, scenes) -> dict[int, ServeResult]:
        """Submit an iterable of (coords, feats[, mask]) scenes and
        return {rrid: result} for THIS call's requests only."""
        rids = [self.submit(*scene) for scene in scenes]
        return self.take(rids)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Finish outstanding work, then stop the pool: every worker's
        scheduler closes and its thread joins; the health ticker joins;
        a submit after close completes with a `rejected` result.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.fault_plan is not None:
            self.fault_plan.close()     # wake injected waits
        try:
            self._settle(lambda: not self._routed, timeout_s=120.0)
        except TimeoutError:
            pass                        # counted work stays addressable
        self._health.close()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.request_stop()
        for w in workers:
            w.thread.join(5.0)
            try:
                w.sched.close()
            except Exception:
                pass
            if w.state in (LIVE, DRAINING):
                w.state = LEFT

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        """Pool-wide serving picture: per-worker state / throughput /
        nested scheduler stats, pooled cache totals, and the failover
        counters (workers lost, requests replayed, failure->recovered
        time)."""
        with self._lock:
            workers = {}
            map_hits = map_misses = asm_hits = asm_misses = 0
            for name, w in self._workers.items():
                st = w.sched.stats()
                mc = st["mapping_cache"]
                map_hits += mc["hits"]
                map_misses += mc["misses"]
                ac = st["assembly_cache"]
                if ac is not None:
                    asm_hits += ac["hits"]
                    asm_misses += ac["misses"]
                workers[name] = {
                    "ordinal": w.ordinal,
                    "state": w.state,
                    "routed": w.n_routed,
                    "processed": w.n_processed,
                    "assigned": w.assigned,
                    "inbox": len(w.inbox),
                    "reason": w.reason,
                    "scheduler": st,
                }
            lookups = map_hits + map_misses + asm_hits + asm_misses
            h_lat = self._h_latency
            return {
                "n_workers": len(self._workers),
                "n_live": sum(1 for w in self._workers.values()
                              if w.state == LIVE),
                "workers": workers,
                "n_submitted": self._c_submitted.value,
                "n_completed": self._c_completed.value,
                "n_ok": self._c_ok.value,
                "routed_incomplete": len(self._routed),
                "latency_avg_s": (h_lat.sum / h_lat.count
                                  if h_lat.count else 0.0),
                "latency_quantiles_s": h_lat.quantiles(),
                "pool_cache": {
                    "mapping_hits": map_hits,
                    "mapping_misses": map_misses,
                    "assembly_hits": asm_hits,
                    "assembly_misses": asm_misses,
                    "combined_hit_rate": ((map_hits + asm_hits) / lookups
                                          if lookups else 0.0),
                },
                "faults": {
                    **{c: m.value for c, m in self._c_faults.items()},
                    "failovers": self._c_failovers.value,
                    "replayed": self._c_replays.value,
                    "recovery_s": self._g_recovery.value,
                },
                "liveness": {
                    "beat_s": self.liveness.beat_s,
                    "miss_beats": self.liveness.miss_beats,
                    "stall_s": self.liveness.stall_s,
                },
                "max_replays": self.max_replays,
                "max_backlog": self.max_backlog,
                # disambiguated alias: the router's bound is PER-WORKER
                # outstanding scenes (vs the scheduler's per-bucket
                # scheduler_max_backlog)
                "router_max_backlog": self.max_backlog,
                "closed": self._closed,
            }
