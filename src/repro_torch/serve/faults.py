"""Fault taxonomy, admission validation, and the fault-injection harness
for the point-cloud serving runtime.

PointAcc's target workloads are real-time streams (AR/VR, autonomous
driving): a serving stack for them must degrade gracefully — one
malformed scene or one failed dispatch must cost exactly that request,
never the stream.  This module holds the three pieces the scheduler
builds its fault-tolerance on:

  * **`ServeError`** — the typed error a request completes with instead
    of an exception escaping `submit()`/`drain()`.  Four codes:

      `rejected`     admission control refused the scene (bad shape /
                     dtype, NaN features, packed-key budget overflow,
                     oversized vs the top ladder bucket, closed
                     scheduler);
      `shed`         load shedding — the bucket's backlog bound was
                     exceeded, newest request rejected;
      `timeout`      the request's `deadline_s` elapsed while it was
                     still queued;
      `exec_failed`  its micro-batch dispatch raised, and the retry /
                     bisect policy could not complete it.

  * **`validate_scene`** — the up-front admission check `submit()` runs
    before a scene touches the pipeline: shapes, dtypes, finite
    features, the packed-key coordinate budget, and the ladder fit.  It
    raises `AdmissionError` (a `ValueError` carrying the error code) so
    the scheduler can route the failure into a `rejected` result.

  * **`FaultPlan`** — the injectable chaos seam threaded through
    `ServeScheduler`/`PointCloudEngine`/`ServeRouter`: fail dispatch *i*
    (one-shot — the retry gets a fresh dispatch id and succeeds), poison
    request *j* (every dispatch containing it fails, exercising the
    bisect isolation path), corrupt submitted scene *k* (NaN features,
    caught by admission control), delay bucket *c* (slow-device
    simulation for deadline / shed / watchdog tests), kill worker *w* at
    its *n*-th served request (the worker thread dies — the router must
    fail it over and replay its queued + in-flight work), hang worker
    *w* (the worker loop stops beating — the router's liveness policy
    must declare it dead by missed heartbeats).  The no-plan path costs
    one `is None` check per seam — the happy path stays bit-identical.
    Every timed wait goes through one wake event, so `close()` (called
    by `ServeScheduler.close()` / `ServeRouter.close()`) wakes pending
    injected delays early and shutdown under chaos is prompt.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Mapping

import numpy as np

from repro_torch.core import mapping as M
from repro_torch.core import packed as PK
from repro_torch.obs import metrics as MX

# -- error taxonomy ---------------------------------------------------------

REJECTED = "rejected"
TIMEOUT = "timeout"
SHED = "shed"
EXEC_FAILED = "exec_failed"
ERROR_CODES = (REJECTED, TIMEOUT, SHED, EXEC_FAILED)

# `rejected` detail codes: a MALFORMED scene can never be served (bad
# shapes/dtypes/values), an OVERSIZED one is well-formed but exceeds the
# ladder — resubmittable through the partition path.  Triage dispatches
# on the detail, not on message text.
OVERSIZED = "oversized"
MALFORMED = "malformed"


@dataclasses.dataclass(frozen=True)
class ServeError:
    """Typed failure a `ServeResult` carries instead of predictions.
    `detail` refines `rejected` results (`oversized` vs `malformed`);
    None elsewhere.  `retry_after_s` is the backpressure hint on `shed`
    and `timeout` results: the estimated seconds until this bucket has
    drained enough that a resubmit would be admitted (computed from the
    observed service rate when an `OverloadController` is attached,
    None when no estimate exists)."""

    code: str                   # one of ERROR_CODES
    message: str
    detail: str | None = None
    retry_after_s: float | None = None

    def __post_init__(self):
        if self.code not in ERROR_CODES:
            raise ValueError(f"unknown serve error code {self.code!r}; "
                             f"expected one of {ERROR_CODES}")

    def __str__(self):
        return f"[{self.code}] {self.message}"


class AdmissionError(ValueError):
    """A scene failed admission validation; `code` is the ServeError
    code the scheduler should complete the request with, `detail` the
    rejection class (`oversized` scenes can be replayed through the
    partition path, `malformed` ones cannot)."""

    def __init__(self, message: str, code: str = REJECTED,
                 detail: str = MALFORMED):
        super().__init__(message)
        self.code = code
        self.detail = detail

    def as_error(self) -> ServeError:
        return ServeError(self.code, str(self), self.detail)


class InjectedFault(RuntimeError):
    """Raised by a `FaultPlan` seam — distinguishable from organic
    failures in logs, handled identically by the retry machinery."""


# -- admission validation ---------------------------------------------------

def validate_scene(coords, feats, mask, ladder, *,
                   check_key_budget: bool = True,
                   coord_dim: int | None = None,
                   feat_shape: tuple | None = None):
    """Validate one raw scene before it enters the serving pipeline.

    Returns `(coords, mask, feats, n, cap)` as host numpy arrays with
    the bucket capacity resolved, or raises `AdmissionError` ("rejected")
    describing exactly what is wrong:

      * coords must be a (N, 1+D) integer-compatible array with every
        valid row finite;
      * mask (when given) must be a (N,) boolean-compatible vector;
      * feats must be (N, C...) with finite values on valid rows — a NaN
        feature would propagate through the whole micro-batch's conv
        trunk, so it is refused up front;
      * with `check_key_budget` (the packed-key v2 engine), valid
        coordinates must fit the 62-bit key budget (batch 0..BATCH_MAX,
        spatial COORD_MIN..COORD_MAX) — out-of-budget points would
        otherwise raise out of the mapping build mid-pipeline;
      * `coord_dim` / `feat_shape` (first-seen values, supplied by the
        scheduler) must match — mixed widths cannot share a micro-batch;
      * N must fit the ladder's top bucket.
    """
    try:
        coords = np.asarray(coords)
    except Exception as e:              # ragged / non-numeric input
        raise AdmissionError(f"coords not array-convertible: {e}")
    if coords.ndim != 2 or coords.shape[1] < 2:
        raise AdmissionError(
            f"coords must be (N, 1+D) with D >= 1, got shape "
            f"{coords.shape}")
    if coord_dim is not None and coords.shape[1] != coord_dim:
        raise AdmissionError(
            f"coords width {coords.shape[1]} does not match this "
            f"scheduler's stream ({coord_dim} columns)")
    n = coords.shape[0]
    if np.issubdtype(coords.dtype, np.floating):
        if not np.isfinite(coords).all():
            raise AdmissionError("coords contain NaN/Inf values")
    elif not np.issubdtype(coords.dtype, np.integer):
        raise AdmissionError(
            f"coords dtype {coords.dtype} is not integer-compatible")

    if mask is None:
        mask = np.ones(n, bool)
    else:
        try:
            mask = np.asarray(mask, bool)
        except Exception as e:
            raise AdmissionError(f"mask not bool-convertible: {e}")
        if mask.shape != (n,):
            raise AdmissionError(
                f"mask shape {mask.shape} does not match {n} coord rows")

    try:
        feats = np.asarray(feats)
    except Exception as e:
        raise AdmissionError(f"feats not array-convertible: {e}")
    if feats.ndim < 1 or feats.shape[0] != n:
        raise AdmissionError(
            f"feats shape {feats.shape} does not match {n} coord rows")
    if feat_shape is not None and feats.shape[1:] != tuple(feat_shape):
        raise AdmissionError(
            f"feats trailing shape {feats.shape[1:]} does not match this "
            f"scheduler's stream ({tuple(feat_shape)})")
    if np.issubdtype(feats.dtype, np.floating) and n:
        valid_feats = feats[mask]
        if valid_feats.size and not np.isfinite(valid_feats).all():
            raise AdmissionError(
                "feats contain NaN/Inf values on valid rows")

    if check_key_budget and coords.shape[1] == 4 and mask.any():
        vc = coords[mask].astype(np.int64)
        # all-sentinel spatial rows are "not a point" to the mapping
        # engine (they sort to the end and never match) — exempt from
        # the budget like the padding they usually are
        vc = vc[(vc[:, 1:] != M.SENTINEL).any(axis=1)]
        if vc.size and ((vc[:, 0] < 0).any()
                        or (vc[:, 0] > PK.BATCH_MAX).any()):
            raise AdmissionError(
                f"batch index outside the packed-key budget "
                f"(0..{PK.BATCH_MAX}); use engine='v1' for such clouds")
        sp = vc[:, 1:]
        if sp.size and ((sp < PK.COORD_MIN).any()
                        or (sp > PK.COORD_MAX).any()):
            raise AdmissionError(
                f"coordinates outside the packed-key budget "
                f"({PK.COORD_MIN}..{PK.COORD_MAX}); use engine='v1' for "
                f"such clouds")

    try:
        cap = ladder.bucket_for(n)
    except ValueError:                  # oversized vs the top bucket
        raise AdmissionError(
            f"scene has {n} rows and exceeds the bucket ladder, which "
            f"tops out at {ladder.capacities[-1]} (buckets "
            f"{ladder.capacities}; the packed-key budget itself allows "
            f"batches 0..{PK.BATCH_MAX} x coords "
            f"{PK.COORD_MIN}..{PK.COORD_MAX}); extend the ladder, or "
            f"serve it chunked via "
            f"PointCloudEngine.segment(partition='auto')",
            detail=OVERSIZED)
    return coords, mask, feats, n, cap


# -- fault injection --------------------------------------------------------

@dataclasses.dataclass
class FaultPlan:
    """Deterministic chaos plan threaded through the serving runtime.

    All seams are thread-safe (producers submit concurrently) and cheap
    enough to leave compiled artifacts untouched: a plan never changes
    shapes or compiled programs, only *when* a wait raises or a scene
    arrives corrupted.

    fail_dispatches : dispatch ordinals (0-based, global across buckets
                      and retries) whose device wait raises
                      `InjectedFault` — retries get fresh ordinals, so a
                      single entry models a transient fault.
    poison_rids     : request ids whose *every* containing dispatch
                      fails — models a scene that crashes the kernel,
                      exercising bisect isolation + `exec_failed`.
    corrupt_scenes  : submit ordinals (0-based, per plan) whose feats
                      are NaN-corrupted before validation — models a
                      garbage sensor frame, caught by admission control.
    delay_buckets   : {bucket_capacity: seconds} waited in the device
                      wait — models a slow device for deadline / shed /
                      watchdog tests.  Interruptible: `close()` wakes
                      pending delays so shutdown under chaos is prompt.
    kill_workers    : {worker_ordinal: step} — the worker's serving loop
                      raises `InjectedFault` when it is about to process
                      its `step`-th request (0-based, counted per
                      worker), crashing the worker thread mid-stream.
                      The request itself and everything queued or in
                      flight on that worker stays incomplete — the
                      router must fail the worker over and replay them.
    hang_workers    : {worker_ordinal: seconds} — the worker's serving
                      loop stops dead for that long on its first request
                      after having served at least one (so the hang hits
                      a *warm* worker mid-stream).  No exception is
                      raised: the worker just stops beating, which is
                      exactly what a wedged device wait looks like — the
                      router's liveness policy must catch it by missed
                      heartbeats.  Woken early by `close()`.
    slow_device     : extra seconds added to *every* dispatch's device
                      wait — a uniformly degraded device, for overload /
                      brownout tests where `delay_buckets` (per-bucket)
                      is too targeted.  Interruptible like the rest.
    storm_buckets   : {bucket_capacity: dispatches_per_second} — caps
                      the bucket's dispatch RATE with token-bucket
                      pacing (each dispatch waits until its slot),
                      giving the bucket a *deterministic service rate*
                      so overload tests can offer a known multiple of
                      capacity.  Distinct from `delay_buckets`, which
                      adds a fixed delay regardless of arrival rate.
    """

    fail_dispatches: frozenset = frozenset()
    poison_rids: frozenset = frozenset()
    corrupt_scenes: frozenset = frozenset()
    delay_buckets: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    kill_workers: Mapping[int, int] = dataclasses.field(
        default_factory=dict)
    hang_workers: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    slow_device: float = 0.0
    storm_buckets: Mapping[int, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        self.fail_dispatches = frozenset(int(i) for i in self.fail_dispatches)
        self.poison_rids = frozenset(int(i) for i in self.poison_rids)
        self.corrupt_scenes = frozenset(int(i) for i in self.corrupt_scenes)
        self.delay_buckets = {int(c): float(s)
                              for c, s in dict(self.delay_buckets).items()}
        self.kill_workers = {int(w): int(s)
                             for w, s in dict(self.kill_workers).items()}
        self.hang_workers = {int(w): float(s)
                             for w, s in dict(self.hang_workers).items()}
        self.slow_device = float(self.slow_device)
        self.storm_buckets = {int(c): float(r)
                              for c, r in dict(self.storm_buckets).items()}
        if any(r <= 0 for r in self.storm_buckets.values()):
            raise ValueError("storm_buckets rates must be > 0 "
                             "dispatches/second")
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._hung: set = set()
        self._storm_next: dict[int, float] = {}     # cap -> next slot time
        # seam-firing counters live in a private registry (one family,
        # labeled per seam) — stats() below is the legacy view over it
        self._mx = MX.MetricsRegistry()
        fam = self._mx.counter("fault_plan_seam_firings_total",
                               "chaos seam firings by kind", ("seam",))
        self._c_submits = fam.labels("submit")
        self._c_corrupted = fam.labels("corrupt")
        self._c_injected = fam.labels("fail")
        self._c_delays = fam.labels("delay")
        self._c_kills = fam.labels("kill")
        self._c_hangs = fam.labels("hang")
        self._c_slows = fam.labels("slow")
        self._c_storms = fam.labels("storm")

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Wake every pending injected wait (bucket delays, worker
        hangs) and skip future ones — called by the scheduler's/router's
        close() so shutdown under chaos never sits out a planned sleep.
        Instant seams (kills, dispatch failures, corruptions) keep
        firing; only the *waits* are cancelled."""
        self._wake.set()

    @property
    def closed(self) -> bool:
        return self._wake.is_set()

    # -- seams (called by the scheduler) ----------------------------------

    def on_submit(self, coords, feats, mask):
        """Admission seam: corrupt the feats of a planned submit ordinal
        (NaN payload — admission control must catch it)."""
        with self._lock:
            i = self._c_submits.value
            self._c_submits.inc()
            corrupt = i in self.corrupt_scenes
            if corrupt:
                self._c_corrupted.inc()
        if corrupt:
            # the whole payload goes NaN (a garbage sensor frame): some
            # row is valid whatever the mask, so admission always trips
            feats = np.full_like(np.asarray(feats, np.float32), np.nan)
        return coords, feats, mask

    def check_wait(self, dispatch_id: int, cap: int, rids) -> None:
        """Wait seam (runs OUTSIDE the scheduler lock): wait out the
        bucket's planned delay (interruptible — `close()` wakes it
        early), then raise `InjectedFault` if this dispatch — or any
        poisoned request on it — is planned to fail."""
        delay = self.delay_buckets.get(int(cap), 0.0)
        if delay > 0:
            with self._lock:
                self._c_delays.inc()
            self._wake.wait(delay)
        if self.slow_device > 0:
            with self._lock:
                self._c_slows.inc()
            self._wake.wait(self.slow_device)
        rate = self.storm_buckets.get(int(cap))
        if rate is not None:
            # token-bucket pacing: each dispatch claims the next slot on
            # a 1/rate grid, so the bucket's service rate is exactly
            # `rate` under saturation regardless of arrival pattern
            now = time.monotonic()
            with self._lock:
                slot = max(self._storm_next.get(int(cap), now), now)
                self._storm_next[int(cap)] = slot + 1.0 / rate
                self._c_storms.inc()
            if slot > now:
                self._wake.wait(slot - now)
        poisoned = self.poison_rids.intersection(int(r) for r in rids)
        if int(dispatch_id) in self.fail_dispatches or poisoned:
            with self._lock:
                self._c_injected.inc()
            raise InjectedFault(
                f"injected dispatch failure (dispatch {dispatch_id}, "
                f"bucket {cap}, rids {sorted(int(r) for r in rids)}"
                + (f", poisoned {sorted(poisoned)}" if poisoned else "")
                + ")")

    def on_worker_step(self, worker: int, step: int) -> None:
        """Worker-loop seam (called by a `ServeRouter` worker thread just
        before it processes its `step`-th request, 0-based per worker):

          * a planned HANG stops the loop cold for the planned duration
            (once, on the first request after the worker has served at
            least one — i.e. on a warm worker) without raising: the
            worker simply stops beating, and the router's liveness
            policy must notice;
          * a planned KILL raises `InjectedFault` at exactly the planned
            step, crashing the worker thread with its queued and
            in-flight work unfinished.
        """
        worker, step = int(worker), int(step)
        hang = self.hang_workers.get(worker)
        if hang is not None:
            with self._lock:
                fire = step >= 1 and worker not in self._hung
                if fire:
                    self._hung.add(worker)
                    self._c_hangs.inc()
            if fire:
                self._wake.wait(hang)
        if self.kill_workers.get(worker) == step:
            with self._lock:
                self._c_kills.inc()
            raise InjectedFault(
                f"injected worker kill (worker {worker}, step {step})")

    # -- telemetry --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"submits_seen": self._c_submits.value,
                    "scenes_corrupted": self._c_corrupted.value,
                    "failures_injected": self._c_injected.value,
                    "delays_injected": self._c_delays.value,
                    "workers_killed": self._c_kills.value,
                    "workers_hung": self._c_hangs.value,
                    "slowdowns_injected": self._c_slows.value,
                    "storm_paced": self._c_storms.value}
