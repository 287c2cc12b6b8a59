"""SLO-aware overload control for the point-cloud serving runtime.

The scheduler has *mechanisms* against overload (a static `max_backlog`
shed bound, per-request deadlines, watchdog flushes) and the *telemetry*
a controller needs (per-bucket scene counters, queue-wait and latency
histograms in one `MetricsRegistry`).  This module closes the loop: an `OverloadController` reads the live
telemetry back into admission and dispatch, so the stack holds its
latency SLO when offered load exceeds capacity instead of queueing
until every completion is late.  Four cooperating pieces:

  * **Adaptive shedding** — the controller estimates each bucket's
    service rate online (EWMA over per-tick deltas of the
    `serve_scenes_total{instance,bucket}` counter — the per-bucket
    series; the instance-level `serve_request_latency_seconds` count
    cross-checks the aggregate) and derives the *effective* backlog
    bound from Little's law: a queue longer than
    `ceil(service_rate x slo.deadline_headroom_s)` cannot drain within
    the SLO, so admitting into it only manufactures late results.  The
    bound is clamped by the static `max_backlog` (never looser) and
    floored at `min_backlog`; with no rate estimate yet (cold start)
    only the static bound applies — the controller never sheds on a
    guess.  Shed and timeout `ServeError`s carry a computed
    `retry_after_s` hint (how long until the bucket drains below the
    bound at the observed rate).

  * **Priority lanes** — `submit(..., priority=)` orders a bucket's
    queue at flush time: higher priority first, earliest deadline first
    within a priority (EDF), FIFO within ties.  Only the *queue order*
    changes — micro-batch shapes and per-scene predictions stay
    bit-identical.

  * **Circuit breakers** — a `CircuitBreaker` per bucket (scheduler)
    and per worker (router) trips OPEN after `k_failures` failures
    inside `window_s` (failed dispatches / `exec_failed`, and
    watchdog-fired deadline flushes — both are "this target is not
    keeping up"); OPEN sheds admissions (scheduler) or routes around
    via the rendezvous ranking (router) for `cooldown_s`, then
    HALF_OPEN admits a single probe: success restores CLOSED, failure
    re-opens.  A probe that never resolves is taken over after another
    `cooldown_s` so a lost probe cannot wedge the breaker.

  * **Brownout ladder** — under *sustained* pressure (some bucket
    pinned at its effective bound for `escalate_after_s`) the
    controller degrades stepwise and recovers in reverse order once
    calm for `recover_after_s`:

        level 1: shrink `max_wait_s` by `wait_shrink` (cut batching
                 latency — partial batches flush sooner);
        level 2: cap `pipeline_depth` at `depth_cap` (bound in-flight
                 memory + queue-time amplification);
        level 3: shed every admission with
                 `priority < shed_below_priority` (lowest lane first —
                 the interactive lanes keep their SLO).

    Every transition is recorded as a `FlightRecorder` incident and a
    span event on the controller's own trace, so a brownout episode is
    reconstructible after the fact.

Wiring: `ServeScheduler(overload=OverloadPolicy(...))` builds and binds
one controller per scheduler; `ServeRouter(overload=...)` forwards the
policy to every worker's scheduler and keeps its own per-worker
breakers.  Every controller hook is gated on `is None` checks in the
scheduler/router hot paths — with no controller the serving paths are
bit-identical to the uncontrolled stack (asserted by tests).

Thread-safety: the controller is owned by exactly one scheduler and
every method is called under that scheduler's lock (same discipline as
the metrics children) — no internal locking.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque

from repro_torch.serve import faults as FLT
from repro_torch.serve.faults import ServeError

# breaker states (gauge encodes them 0/1/2 so dashboards can alert on
# "any breaker > 0")
CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

MAX_BROWNOUT_LEVEL = 3


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Circuit breaker tuning: trip after `k_failures` failures inside
    `window_s`; stay OPEN for `cooldown_s` before the HALF_OPEN probe
    (and take over a probe that has not resolved after another
    `cooldown_s`)."""

    k_failures: int = 5
    window_s: float = 2.0
    cooldown_s: float = 0.5

    def __post_init__(self):
        if self.k_failures < 1:
            raise ValueError("k_failures must be >= 1")
        if self.window_s <= 0 or self.cooldown_s <= 0:
            raise ValueError("window_s and cooldown_s must be > 0")


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """The latency objective the controller defends:
    `deadline_headroom_s` is the queueing budget — the longest a queue
    may take to drain (at the observed service rate) before admitting
    into it would blow the SLO."""

    deadline_headroom_s: float = 0.25

    def __post_init__(self):
        if self.deadline_headroom_s <= 0:
            raise ValueError("deadline_headroom_s must be > 0")


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """Brownout ladder tuning (see the module docstring for the level
    semantics).  Escalation requires pressure *sustained* for
    `escalate_after_s`; recovery requires calm for `recover_after_s`
    (longer, so the ladder does not flap)."""

    escalate_after_s: float = 0.5
    recover_after_s: float = 1.0
    wait_shrink: float = 0.5
    depth_cap: int = 1
    shed_below_priority: int = 0

    def __post_init__(self):
        if self.escalate_after_s <= 0 or self.recover_after_s <= 0:
            raise ValueError("escalate/recover intervals must be > 0")
        if not 0.0 < self.wait_shrink <= 1.0:
            raise ValueError("wait_shrink must be in (0, 1]")
        if self.depth_cap < 0:
            raise ValueError("depth_cap must be >= 0")


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Everything the controller needs: the SLO, the estimator cadence
    (`tick_s` between rate re-estimates, `ewma_alpha` smoothing), the
    adaptive bound floor (`min_backlog` — the bound never starves a
    bucket below this many outstanding scenes), and the breaker +
    brownout sub-policies."""

    slo: ServeSLO = ServeSLO()
    tick_s: float = 0.05
    ewma_alpha: float = 0.4
    min_backlog: int = 1
    breaker: BreakerPolicy = BreakerPolicy()
    brownout: BrownoutPolicy = BrownoutPolicy()

    def __post_init__(self):
        if self.tick_s <= 0:
            raise ValueError("tick_s must be > 0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.min_backlog < 1:
            raise ValueError("min_backlog must be >= 1")


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN -> CLOSED failure breaker.

    Not internally locked: every call happens under the owning
    component's lock.  `now` is injectable everywhere so the state
    machine is unit-testable without sleeping.  `gauge` (optional) is a
    metrics Gauge child kept at the STATE_CODE of the current state.
    """

    def __init__(self, policy: BreakerPolicy, name: str = "",
                 gauge=None):
        self.policy = policy
        self.name = name
        self.gauge = gauge
        self.state = CLOSED
        self._failures: deque[float] = deque()
        self._opened_at: float | None = None
        self._probe_at: float | None = None
        self.n_trips = 0
        if gauge is not None:
            gauge.set(STATE_CODE[CLOSED])

    def _set(self, state: str) -> None:
        self.state = state
        if self.gauge is not None:
            self.gauge.set(STATE_CODE[state])

    def _prune(self, now: float) -> None:
        horizon = now - self.policy.window_s
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()

    def allow(self, now: float | None = None) -> bool:
        """May a request be admitted/routed to this target right now?
        The first allow after the cooldown IS the half-open probe —
        callers must report its outcome via record_success/failure."""
        now = time.monotonic() if now is None else now
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if now - self._opened_at >= self.policy.cooldown_s:
                self._set(HALF_OPEN)
                self._probe_at = now
                return True
            return False
        # HALF_OPEN: one probe at a time, but a probe that never
        # resolved (lost request) is taken over after a cooldown
        if self._probe_at is None or \
                now - self._probe_at >= self.policy.cooldown_s:
            self._probe_at = now
            return True
        return False

    def record_failure(self, now: float | None = None) -> bool:
        """Count one failure; returns True when this call TRIPPED the
        breaker (CLOSED->OPEN or a failed HALF_OPEN probe)."""
        now = time.monotonic() if now is None else now
        self._failures.append(now)
        self._prune(now)
        if self.state == HALF_OPEN:
            self._opened_at = now
            self._probe_at = None
            self.n_trips += 1
            self._set(OPEN)
            return True
        if self.state == CLOSED and \
                len(self._failures) >= self.policy.k_failures:
            self._opened_at = now
            self.n_trips += 1
            self._set(OPEN)
            return True
        return False

    def record_success(self, now: float | None = None) -> None:
        """A request against this target completed fine; a HALF_OPEN
        probe success restores CLOSED and clears the failure window."""
        if self.state == HALF_OPEN:
            self._failures.clear()
            self._opened_at = None
            self._probe_at = None
            self._set(CLOSED)

    def retry_after(self, now: float | None = None) -> float:
        """Seconds until the next probe slot (the retry hint a shed
        caused by this breaker should carry)."""
        now = time.monotonic() if now is None else now
        anchor = self._opened_at if self.state == OPEN else self._probe_at
        if anchor is None:
            return 0.0
        return max(0.0, anchor + self.policy.cooldown_s - now)


class OverloadController:
    """The control loop: telemetry -> admission/dispatch policy.

    Owned by exactly one `ServeScheduler` (`bind()` wires the gauges and
    records the knobs the brownout ladder mutates); every method is
    called under that scheduler's lock.  `clock` is injectable for
    deterministic tests.
    """

    def __init__(self, policy: OverloadPolicy | None = None,
                 clock=time.monotonic):
        self.policy = policy if policy is not None else OverloadPolicy()
        self._clock = clock
        self._sched = None
        self._rates: dict[int, float] = {}       # cap -> EWMA scenes/s
        # completions per bucket, fed by record_dispatch_success at
        # retire time: the estimator MUST measure service (completion)
        # throughput — the dispatch-time scene counters track admission
        # under deferred dispatch, and an estimator reading those
        # converges on the offered rate instead of capacity
        self._completed: dict[int, int] = {}
        self._prev_scenes: dict[int, int] = {}   # cap -> last fold value
        self._last_fold: dict[int, float] = {}   # cap -> last delta>0 time
        self._est_start: float | None = None     # first-snapshot time
        self._prev_lat_count = 0
        self._total_fold: float | None = None    # last aggregate fold
        self._total_rate = 0.0                   # EWMA completions/s
        self._last_tick: float | None = None
        self.level = 0
        self.n_transitions = 0
        self._pressure_since: float | None = None
        self._calm_since: float | None = None
        self._bucket_breakers: dict[int, CircuitBreaker] = {}
        self._orig_max_wait_s = None
        self._orig_pipeline_depth = None
        self._trace_id = None
        # gauges bound at bind()
        self._g_state = None
        self._fam_eff = None
        self._fam_breaker = None

    # -- wiring ------------------------------------------------------------

    def bind(self, sched) -> None:
        """Attach to the owning scheduler: register the controller
        gauges under its instance label and record the original values
        of the knobs the brownout ladder mutates."""
        self._sched = sched
        self._orig_max_wait_s = sched.max_wait_s
        self._orig_pipeline_depth = sched.pipeline_depth
        reg, inst = sched.obs.registry, sched.instance
        self._g_state = reg.gauge(
            "serve_overload_state",
            "brownout ladder level (0 = nominal)",
            ("instance",)).labels(inst)
        self._g_state.set(0)
        self._fam_eff = reg.gauge(
            "serve_effective_backlog",
            "adaptive per-bucket admission bound (Little's law)",
            ("instance", "bucket"))
        self._fam_breaker = reg.gauge(
            "serve_breaker_state",
            "circuit breaker state (0 closed / 1 half-open / 2 open)",
            ("instance", "target"))

    def close(self) -> None:
        """Restore the knobs the ladder mutated and close the
        controller's trace (if transitions opened one)."""
        if self._sched is not None and self.level > 0:
            self._sched.max_wait_s = self._orig_max_wait_s
            self._sched.pipeline_depth = self._orig_pipeline_depth
        tr = self._tracer()
        if tr is not None and self._trace_id is not None:
            tr.end(self._trace_id, outcome="ok")
            self._trace_id = None

    def _tracer(self):
        return self._sched.obs.tracer if self._sched is not None else None

    def bucket_breaker(self, cap: int) -> CircuitBreaker:
        br = self._bucket_breakers.get(cap)
        if br is None:
            gauge = None
            if self._fam_breaker is not None:
                gauge = self._fam_breaker.labels(
                    self._sched.instance, f"bucket:{cap}")
            br = CircuitBreaker(self.policy.breaker,
                                name=f"bucket:{cap}", gauge=gauge)
            self._bucket_breakers[cap] = br
        return br

    # -- rate estimation ---------------------------------------------------

    def maybe_tick(self, now: float | None = None) -> None:
        """Rate-limited tick: cheap no-op until `tick_s` has elapsed
        since the last estimate (called opportunistically from the
        scheduler's deadline sweep, i.e. from submit()/poll() and the
        watchdog)."""
        now = self._clock() if now is None else now
        if self._last_tick is not None and \
                now - self._last_tick < self.policy.tick_s:
            return
        self.tick(now)

    def tick(self, now: float | None = None) -> None:
        """One estimator step: fold the per-bucket completion-counter
        deltas into the EWMA service rates, refresh the effective-
        backlog gauges, and advance the brownout ladder.

        A rate sample is taken only on ticks where scenes COMPLETED,
        over the elapsed time since the bucket's previous completion-
        bearing tick.  Retirement lands in whole micro-batches, so the
        zero-delta ticks between completions carry no rate information
        — folding them in would whipsaw the EWMA toward zero exactly
        when the admission bound matters most.  Idle buckets likewise
        keep their last estimate."""
        now = self._clock() if now is None else now
        sched = self._sched
        if self._last_tick is None:
            # first tick only snapshots the counters — a rate needs two
            # observations
            self._last_tick = now
            self._est_start = now
            for cap, done in self._completed.items():
                self._prev_scenes[cap] = done
                self._last_fold[cap] = now
            self._prev_lat_count = sched._h_latency.count
            return
        if now - self._last_tick <= 0:
            return
        self._last_tick = now
        a = self.policy.ewma_alpha
        for cap, cur in self._completed.items():
            delta = cur - self._prev_scenes.get(cap, 0)
            if delta <= 0:
                continue
            self._prev_scenes[cap] = cur
            since = now - self._last_fold.get(cap, self._est_start)
            self._last_fold[cap] = now
            if since <= 0:
                continue
            inst = delta / since
            old = self._rates.get(cap)
            self._rates[cap] = inst if old is None else \
                (1.0 - a) * old + a * inst
        # aggregate completion rate (latency-histogram count deltas) —
        # the cross-check series the retry hints fall back to
        lat_count = sched._h_latency.count
        lat_delta = lat_count - self._prev_lat_count
        if lat_delta > 0:
            self._prev_lat_count = lat_count
            since = now - (self._total_fold if self._total_fold
                           is not None else self._est_start)
            self._total_fold = now
            if since > 0:
                inst = lat_delta / since
                self._total_rate = inst if self._total_rate <= 0 else \
                    (1.0 - a) * self._total_rate + a * inst
        self._update_brownout(now)

    def service_rate(self, cap: int) -> float | None:
        """EWMA scenes/s for one bucket; None before the estimator has
        seen the bucket complete work."""
        return self._rates.get(cap)

    def effective_backlog(self, cap: int) -> int | None:
        """Little's-law admission bound for one bucket:
        ceil(service_rate x deadline_headroom_s), floored at
        `min_backlog` AND at two full micro-batches (one executing, one
        assembling — bounding below that cannot sustain continuous
        batching, and would starve the very throughput the bound is
        estimated from), clamped by the static `max_backlog`.  None
        means unbounded (no rate estimate AND no static bound)."""
        static = self._sched.max_backlog
        rate = self._rates.get(cap)
        if rate is None or rate <= 0:
            return static
        bound = max(self.policy.min_backlog,
                    2 * self._sched.max_batch_for(cap),
                    math.ceil(rate * self.policy.slo.deadline_headroom_s))
        if static is not None:
            bound = min(bound, static)
        if self._fam_eff is not None:
            self._fam_eff.labels(self._sched.instance,
                                 str(cap)).set(bound)
        return bound

    def retry_after(self, cap: int, outstanding: int) -> float:
        """Backpressure hint: estimated seconds until this bucket has
        drained below its effective bound at the observed service rate
        (the `retry_after_s` a shed/timeout ServeError carries)."""
        rate = self._rates.get(cap)
        if rate is not None and rate > 0:
            bound = self.effective_backlog(cap)
            excess = outstanding - (bound if bound is not None
                                    else outstanding) + 1
            return max(0.0, excess / rate)
        return self.policy.slo.deadline_headroom_s

    def retry_after_hint(self) -> float:
        """Instance-aggregate hint (routers aggregate these across
        workers): total outstanding work over the total observed
        completion rate, falling back to the SLO headroom."""
        sched = self._sched
        total_out = sum(sched._outstanding.values())
        if self._total_rate > 0:
            return max(0.0, total_out / self._total_rate)
        return self.policy.slo.deadline_headroom_s

    # -- admission ---------------------------------------------------------

    def check_admission_locked(self, cap: int, outstanding: int,
                               priority: int) -> ServeError | None:
        """The controller's admission gate, called from submit() under
        the scheduler lock AFTER the static max_backlog check (the
        static path's behaviour and message stay as without a
        controller).  Returns the shed error, or None to admit."""
        now = self._clock()
        self.maybe_tick(now)
        bp = self.policy.brownout
        if self.level >= 3 and priority < bp.shed_below_priority:
            return ServeError(
                FLT.SHED,
                f"brownout level {self.level}: priority {priority} lane "
                f"shed (lanes below {bp.shed_below_priority} are browned "
                f"out)", retry_after_s=self.retry_after(cap, outstanding))
        br = self._bucket_breakers.get(cap)
        if br is not None and br.state != CLOSED and not br.allow(now):
            return ServeError(
                FLT.SHED,
                f"bucket {cap} circuit breaker {br.state} after repeated "
                f"dispatch failures ({br.policy.k_failures} in "
                f"{br.policy.window_s}s window)",
                retry_after_s=br.retry_after(now))
        bound = self.effective_backlog(cap)
        static = self._sched.max_backlog
        if bound is not None and outstanding >= bound and \
                (static is None or bound < static):
            # tighter than the static bound -> the adaptive shed; at the
            # static bound the scheduler's own check fires (message
            # compatibility) with the retry hint attached
            rate = self._rates.get(cap)
            return ServeError(
                FLT.SHED,
                f"bucket {cap} backlog at the adaptive bound ({outstanding}"
                f" outstanding >= {bound}; service rate "
                f"{rate:.1f} scenes/s x {self.policy.slo.deadline_headroom_s}"
                f"s headroom; static max_backlog "
                f"{static if static is not None else 'unbounded'})",
                retry_after_s=self.retry_after(cap, outstanding))
        return None

    # -- breaker hooks -----------------------------------------------------

    def record_dispatch_success(self, cap: int, n_scenes: int = 0) -> None:
        """A micro-batch retired cleanly: feed the breaker and count its
        `n_scenes` real scenes toward the bucket's service-rate
        estimate (the estimator's ONLY input — see tick())."""
        if n_scenes > 0:
            self._completed[cap] = self._completed.get(cap, 0) + n_scenes
        br = self._bucket_breakers.get(cap)
        if br is not None:
            br.record_success(self._clock())

    def record_dispatch_failure(self, cap: int) -> None:
        br = self.bucket_breaker(cap)
        if br.record_failure(self._clock()):
            self._incident("breaker_trip", target=f"bucket:{cap}",
                           state=br.state, trips=br.n_trips)

    # -- brownout ladder ---------------------------------------------------

    def _update_brownout(self, now: float) -> None:
        bp = self.policy.brownout
        sched = self._sched
        pressured = False
        for cap, out in sched._outstanding.items():
            if out <= 0:
                continue
            bound = self.effective_backlog(cap)
            if bound is not None and out >= bound:
                pressured = True
                break
        if pressured:
            self._calm_since = None
            if self._pressure_since is None:
                self._pressure_since = now
            elif now - self._pressure_since >= bp.escalate_after_s \
                    and self.level < MAX_BROWNOUT_LEVEL:
                self._transition(self.level + 1, now)
                self._pressure_since = now      # re-arm for the next step
        else:
            self._pressure_since = None
            if self.level == 0:
                self._calm_since = None
            elif self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= bp.recover_after_s:
                self._transition(self.level - 1, now)
                self._calm_since = now          # re-arm for the next step

    def _transition(self, level: int, now: float) -> None:
        """Move the ladder one step and apply the level's knob values
        (originals restored on the way back down)."""
        prev, self.level = self.level, level
        self.n_transitions += 1
        bp = self.policy.brownout
        sched = self._sched
        if self._orig_max_wait_s is not None:
            sched.max_wait_s = self._orig_max_wait_s \
                if level < 1 else self._orig_max_wait_s * bp.wait_shrink
        sched.pipeline_depth = self._orig_pipeline_depth \
            if level < 2 else min(self._orig_pipeline_depth, bp.depth_cap)
        if self._g_state is not None:
            self._g_state.set(level)
        self._incident("brownout", prev_level=prev, level=level,
                       direction="escalate" if level > prev else "recover",
                       max_wait_s=sched.max_wait_s,
                       pipeline_depth=sched.pipeline_depth)

    def _incident(self, kind: str, **attrs) -> None:
        """One controller incident: a FlightRecorder dump + a span event
        on the controller's own trace (opened lazily, closed by
        close())."""
        sched = self._sched
        rec = sched.obs.recorder
        if rec is not None:
            rec.record(kind, instance=sched.instance, **attrs)
            rec.dump(kind, key=(kind, sched.instance,
                                self.n_transitions,
                                sum(b.n_trips
                                    for b in self._bucket_breakers.values())))
        tr = self._tracer()
        if tr is not None:
            if self._trace_id is None:
                self._trace_id = f"{sched.instance}:overload"
                tr.begin(self._trace_id, instance=sched.instance,
                         controller=True)
            tr.event(self._trace_id, kind, **attrs)

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        """Controller state snapshot (NOT part of the frozen scheduler
        stats() schema — callers reach it via `sched.overload`)."""
        return {
            "level": self.level,
            "transitions": self.n_transitions,
            "service_rate": {int(c): r for c, r in self._rates.items()},
            "total_rate": self._total_rate,
            "effective_backlog": {
                int(c): self.effective_backlog(c) for c in self._rates},
            "breakers": {b.name: {"state": b.state, "trips": b.n_trips}
                         for b in self._bucket_breakers.values()},
        }


def resolve_controller(overload) -> OverloadController | None:
    """Normalize the `overload=` constructor argument: None stays off,
    True means default policy, a policy builds a controller, a
    controller is used as-is."""
    if overload is None or overload is False:
        return None
    if overload is True:
        return OverloadController(OverloadPolicy())
    if isinstance(overload, OverloadPolicy):
        return OverloadController(overload)
    if isinstance(overload, OverloadController):
        return overload
    raise TypeError(
        f"overload= takes None/True/OverloadPolicy/OverloadController, "
        f"got {type(overload).__name__}")
