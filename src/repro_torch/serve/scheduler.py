"""Continuous-batching serve scheduler for point-cloud segmentation on
the card.

Scenes arrive one at a time with heterogeneous point counts; the engine
wants fixed bucket shapes and the card wants full micro-batches.
`ServeScheduler` closes the gap as a small pipelined runtime:

  * **admission** — `submit()` validates each scene up front
    (`serve.faults.validate_scene`: shapes, dtypes, finite features, the
    packed-key coordinate budget, the ladder fit) and refuses bad input
    with a typed `rejected` result instead of crashing mid-pipeline;
    accepted scenes are padded to their capacity bucket
    (`serve.buckets.BucketLadder`), digested once, and queued with their
    bucket peers.  Bounded backlog (`max_backlog`) sheds the newest
    request with a `shed` result when a bucket backs up; a per-request
    `deadline_s` converts overdue queued requests into `timeout`
    results.  `submit` is thread-safe, so producers can admit scenes
    while a micro-batch executes;
  * **grouping** — a bucket queue that reaches its `max_batch` width
    (per-bucket overrides supported) executes at once as one
    micro-batch; `flush()` runs stragglers with fully-masked dummy
    scenes; `max_wait_s` adds a deadline — a partial micro-batch executes
    once its oldest queued request has waited that long (checked in
    `submit()`/`poll()` and by the background watchdog).  Every
    execution of a bucket has the same (max_batch, bucket_capacity)
    shape, so `PointCloudEngine.compile_stats` stays bounded by the
    number of buckets;
  * **assembly** — per-scene level pyramids come from the session's
    digest-keyed `MappingCache`; the micro-batch's operands (the tuple of
    its scenes' pyramids, the staged coordinates and masks on the device)
    are cached one level up in a composition-keyed `AssemblyCache`
    (`repro_torch.api`), so a hot loop replaying the same ordered batch
    composition skips the per-scene lookups and the coordinate copies.
    Host staging goes through preallocated per-(bucket, max_batch)
    arenas filled in place, pinned when the engine runs on CUDA and
    copied to the card with `non_blocking=True`;
  * **execution** — `engine._apply_batch` runs the micro-batch's scenes
    one after another through the same code as `PointCloudEngine.segment`
    (`minkunet_apply` with the engine's flow, then argmax), so labels are
    bit-identical to `segment`; dummy scenes carry no pyramid and are
    skipped.  Dispatch is asynchronous: the labels are copied into
    pinned host memory with `non_blocking=True` and a CUDA event is
    recorded after the copy; `_run_bucket` parks that in-flight slot
    (`pipeline_depth` per bucket) instead of blocking, so assembling
    micro-batch i+1 overlaps the card executing micro-batch i.  On the
    CPU every slot is ready when it is parked.  `pipeline_depth=0` is
    the synchronous path (`assembly_cache_entries=0` keeps the arenas
    and drops only the assembly cache);
  * **failure isolation** — a dispatch whose wait raises does not
    poison the FIFO: the slot is dropped, its requests are retried as
    fresh dispatches (bisected into halves when the batch held several
    scenes, isolating a single poison scene in O(log max_batch)
    rounds), and a request that exhausts its `max_retries` re-dispatch
    budget completes with a typed `exec_failed` result while the
    scheduler keeps serving.  `serve.faults.FaultPlan` is the injectable
    chaos seam the policy is tested with;
  * **completion** — in-flight slots retire in `drain()` / `poll()` /
    `flush()` / `take()`; `poll()` retires only slots whose event has
    completed (`Event.query()`), `drain()`/`take()` block on the events
    (`Event.synchronize()`), and the background watchdog (`watchdog_s`,
    a `launch.fault_tolerance.Ticker`) retires ready slots and fires
    `max_wait_s` deadline flushes on an idle scheduler.  Results
    complete out of submission order with per-request latency, padding
    and cache telemetry; errors arrive as `ServeResult.error` (typed
    taxonomy: rejected / shed / timeout / exec_failed) — no exception
    escapes `submit`/`poll`/`drain`/`take`/`serve` for a per-request
    problem.  `stats()` aggregates the serving picture with the
    reference's key sets (`obs.metrics.SCHEDULER_STATS_KEYS`).
    `close()` (or the context manager) drains in-flight work and joins
    the watchdog thread.

Dispatch runs under `torch.cuda.device(engine.device)` on the calling
thread's current stream, whichever thread (a producer, `drain()`, the
watchdog) dispatches.  `mesh="auto"` splits each micro-batch's scenes
over the host's CUDA devices (`distributed.sharding.make_scene_mesh`), and
resolves to None on one card: the engine's device serves every
micro-batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.api import AssemblyCache
from repro_torch.core import mapping as M
from repro_torch.distributed import sharding as SH
from repro_torch.launch import fault_tolerance as FT
from repro_torch.obs import Observability
from repro_torch.serve import buckets as BK
from repro_torch.serve import faults as FLT
from repro_torch.serve import overload as OV
from repro_torch.serve.faults import ServeError

DEFAULT_PIPELINE_DEPTH = 2
DEFAULT_ASSEMBLY_ENTRIES = 16
DEFAULT_MAX_RETRIES = 2
_MIN_WATCHDOG_S = 0.005


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One admitted scene, already padded to its bucket capacity."""

    rid: int
    coords: np.ndarray          # (bucket, 1+D) int32, sentinel-padded
    mask: np.ndarray            # (bucket,) bool
    feats: np.ndarray           # (bucket, C)
    n_points: int               # caller's row count (pre-padding)
    n_valid: int                # unmasked rows (what the bucket serves)
    bucket: int                 # capacity bucket the scene landed in
    t_submit: float
    key: bytes = None           # pyramid digest (None on the legacy path)
    deadline: float | None = None   # absolute monotonic queue deadline
    priority: int = 0           # lane: higher dispatches first at flush


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served scene, un-padded back to the caller's row count.

    Exactly one of `preds` / `error` is set: a request either completes
    with predictions or with a typed `ServeError` (rejected / shed /
    timeout / exec_failed) — the stream survives either way.
    """

    rid: int
    preds: np.ndarray | None    # (n_points,) int32 class ids; None on error
    n_points: int
    bucket: int                 # -1 when the scene never reached a bucket
    padding_frac: float         # dead fraction of the bucket's rows
                                # (padding + pre-masked rows)
    mapping_hit: bool           # scene's level pyramid came from cache
                                # (per-scene hit, or via a whole-batch
                                # assembly-cache hit)
    latency_s: float            # submit -> result (queue wait included)
    error: ServeError | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class _InFlight:
    """One dispatched, not-yet-retired micro-batch."""

    cap: int
    reqs: list                  # real requests only (dummies carry none)
    hits: list                  # per-request mapping/assembly hit flags
    preds: torch.Tensor | None  # (max_batch, cap) int32 labels on the host
                                # (pinned; final once `done` completes)
    dispatch_id: int = 0        # global dispatch ordinal (fault seam key)
    retries: int = 0            # redispatch generation (0 = fresh)
    done: torch.cuda.Event | None = None   # recorded after the copy; None
                                           # on the CPU (ready at once)

    def ready(self) -> bool:
        """Are the labels on the host?  A query that raises propagates."""
        return self.done is None or self.done.query()


class _HostArena:
    """Preallocated host staging buffers for one (bucket, max_batch).

    Micro-batches are filled in place (no per-batch `np.stack`
    allocation), rotating over `depth` slots so assembling batch i+1 never
    touches the slot batch i was shipped from: the host half of the
    double buffer.  On CUDA the buffers are pinned, the copies to the card
    are non-blocking, and a slot is refilled only after the event recorded
    behind its last copies has completed.  feats is allocated lazily on
    first fill (channel count and dtype come from traffic, not config).
    """

    def __init__(self, depth: int, max_batch: int, cap: int,
                 coord_dim: int, device: torch.device):
        self.depth = max(1, depth)
        self.device = device
        self.pin = device.type == "cuda"
        self._coords = torch.full((self.depth, max_batch, cap, coord_dim),
                                  M.SENTINEL, dtype=torch.int32,
                                  pin_memory=self.pin)
        self._mask = torch.zeros((self.depth, max_batch, cap),
                                 dtype=torch.bool, pin_memory=self.pin)
        self._feats = None
        self.coords = self._coords.numpy()      # in-place fill views
        self.mask = self._mask.numpy()
        self.feats = None
        self._copied = [None] * self.depth
        self._slot = -1

    def next_slot(self, feats_like: np.ndarray) -> int:
        # reallocate on a channel-count/dtype change so a mixed stream is
        # staged at the caller's dtype (no silent in-place downcast)
        shape = self.mask.shape + feats_like.shape[1:]
        if self.feats is None or self.feats.shape != shape \
                or self.feats.dtype != feats_like.dtype:
            self._feats = torch.from_numpy(
                np.zeros(shape, feats_like.dtype))
            if self.pin:
                self._feats = self._feats.pin_memory()
            self.feats = self._feats.numpy()
        self._slot = (self._slot + 1) % self.depth
        done, self._copied[self._slot] = self._copied[self._slot], None
        if done is not None:
            done.synchronize()
        return self._slot

    def to_device(self, name: str, slot: int) -> torch.Tensor:
        """A device copy of one slot's buffer (a new tensor on the CPU too,
        so a cached copy never aliases the arena)."""
        src = getattr(self, "_" + name)[slot]
        return src.to(self.device, non_blocking=True, copy=True)

    def shipped(self, slot: int) -> None:
        """Mark the slot's copies as issued (an event behind them)."""
        if self.pin:
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()


def _labels_to_host(labels: torch.Tensor):
    """(host labels, event): a non-blocking copy of the labels into pinned
    host memory and the CUDA event recorded behind it; on the CPU the
    labels themselves and no event."""
    if labels.device.type != "cuda":
        return labels, None
    host = torch.empty(labels.shape, dtype=labels.dtype, pin_memory=True)
    host.copy_(labels, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class ServeScheduler:
    """Bucketed continuous batching in front of a `PointCloudEngine`.

    The engine owns the model + session (flow/engine policy, MappingCache)
    and the per-scene and micro-batch entry points; the scheduler owns the
    traffic: queues per capacity bucket, fixed-shape micro-batches, the
    composition-keyed assembly cache, the in-flight pipeline, the
    failure-isolation policy, and serving telemetry.

    mesh="auto" picks a scene-axis mesh over the host's CUDA devices
    (`sharding.make_scene_mesh`; None on one card) and runs micro-batches
    through `sharding.shard_over_scenes`, one engine replica a device;
    `max_batch` widths are rounded up to a multiple of the device count so
    the scene axis always divides the mesh.  A `SceneMesh` may be passed
    (e.g. `make_scene_mesh(devices=[...])`); None serves on the engine's
    device.

    max_batch              : int, {capacity: width, "default": w} dict,
                             or None (ladder-level `BucketLadder.max_batch`
                             config, else `buckets.DEFAULT_MAX_BATCH`).
    pipeline_depth         : in-flight micro-batches per bucket before
                             dispatch blocks on the oldest; 0 = fully
                             synchronous execution.
    assembly_cache_entries : LRU bound of the composition-keyed stacked-
                             operand cache; 0 disables the cache (every
                             batch is gathered through the mapping cache).
    max_wait_s             : deadline before a partial micro-batch
                             executes anyway (None = only on flush).
    validate               : admission validation (`faults.validate_scene`)
                             on submit; malformed / oversized scenes
                             complete with a `rejected` result instead of
                             raising.  False skips it: a ladder overflow
                             then raises out of submit().
    max_backlog            : PER-BUCKET bound on outstanding (queued +
                             in-flight) scenes; a submit beyond it is
                             shed with a `shed` result.  None = unbounded.
                             A natural setting is
                             (pipeline_depth + 1) * max_batch.  (The
                             router's same-named knob is PER-WORKER —
                             scenes assigned to one worker across all
                             buckets; `stats()` surfaces this one as
                             `scheduler_max_backlog`.)  With an
                             `overload` controller the EFFECTIVE bound
                             tightens adaptively to
                             ceil(service_rate x deadline_headroom)
                             (never looser than this static bound).
    max_retries            : re-dispatch budget per request after a
                             failed execution (2 isolates one poison
                             scene in a micro-batch of up to 4 via
                             bisect); a request that exhausts it
                             completes with `exec_failed`.
    retry_bisect           : split a failed multi-scene batch into halves
                             on retry (poison isolation) instead of
                             retrying it whole.
    retry_backoff_s        : base of the jittered exponential backoff
                             slept before each retry dispatch —
                             generation g waits retry_backoff_s * 2^g *
                             uniform(0.5, 1.5), so a transiently sick
                             device is not hammered with immediate
                             redispatches and concurrent retriers
                             decorrelate.  The default 0 keeps retries
                             immediate.  The wait releases the scheduler
                             lock, so producers keep admitting scenes
                             while a retry backs off.
    retry_backoff_seed     : seed for the backoff jitter RNG — two
                             schedulers built with the same seed produce
                             identical backoff schedules (deterministic
                             chaos tests).  None (default) keeps the
                             module-level `random` source.
    overload               : `overload.OverloadPolicy` (or True for the
                             defaults, or a pre-built
                             `OverloadController`) — attaches the
                             SLO-aware overload controller: adaptive
                             shedding from the observed service rate,
                             priority/EDF queue ordering, per-bucket
                             circuit breakers, and the brownout ladder
                             (see `serve/overload.py`).  With a
                             controller, pipeline depth is enforced by
                             DEFERRING dispatch (full batches queue
                             until a slot retires — submit never blocks
                             on a device wait) instead of by the
                             blocking depth-overflow loop; the queues
                             that build are what the priority lanes
                             order and the adaptive bound sheds.  None
                             (default) keeps every serving path
                             bit-identical to the uncontrolled
                             scheduler.
    watchdog_s             : background ticker interval — fires
                             `max_wait_s` deadline flushes, expires
                             per-request deadlines and retires ready
                             slots on an idle scheduler.  None = auto
                             (max_wait_s / 4 when max_wait_s is set,
                             else off); 0 disables.  `close()` joins it.
    fault_plan             : `faults.FaultPlan` chaos seam (tests/CI);
                             None (the default) leaves the hot path
                             bit-identical.

    `submit`/`poll`/`drain`/`take`/`flush`/`stats` are thread-safe (one
    reentrant lock around queues, caches and telemetry), so producers can
    admit scenes while earlier micro-batches execute — including while
    another thread sits in `drain()`/`flush()`: the lock is released for
    the duration of every device wait (see `_retire_oldest_locked`).
    None of them raise for per-request problems — a request always
    completes, with predictions or with a typed `ServeResult.error`.
    """

    def __init__(self, engine, max_batch=None, mesh="auto",
                 axis: str = "scene",
                 pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
                 assembly_cache_entries: int = DEFAULT_ASSEMBLY_ENTRIES,
                 max_wait_s: float | None = None,
                 validate: bool = True,
                 max_backlog: int | None = None,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 retry_bisect: bool = True,
                 retry_backoff_s: float = 0.0,
                 retry_backoff_seed: int | None = None,
                 overload=None,
                 watchdog_s: float | None = None,
                 fault_plan: FLT.FaultPlan | None = None,
                 obs: Observability | None = None,
                 instance: str = "scheduler"):
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if max_backlog is not None and max_backlog < 1:
            raise ValueError("max_backlog must be >= 1 (or None)")
        self.engine = engine
        self.ladder: BK.BucketLadder = engine.ladder
        if mesh == "auto":
            mesh = SH.make_scene_mesh(axis)
        self.mesh = mesh
        n_dev = mesh.size if mesh is not None else 1
        if mesh is not None:
            self._apply = SH.shard_over_scenes(
                [engine._apply_batch if torch.device(d) == engine.device
                 else engine.replica(d)._apply_batch for d in mesh.devices],
                mesh, axis)
        else:
            self._apply = engine._apply_batch
        self.device = engine.device
        default, overrides = BK.resolve_max_batch(max_batch, self.ladder)

        def round_up(b):
            return n_dev * max(1, math.ceil(b / n_dev))
        self.max_batch = round_up(default)
        self.max_batch_overrides = {c: round_up(b)
                                    for c, b in dict(overrides).items()}
        self.pipeline_depth = int(pipeline_depth)
        self.max_wait_s = max_wait_s
        self.validate = bool(validate)
        self.max_backlog = max_backlog
        self.max_retries = int(max_retries)
        self.retry_bisect = bool(retry_bisect)
        self.retry_backoff_s = float(retry_backoff_s)
        self._rng = random.Random(retry_backoff_seed) \
            if retry_backoff_seed is not None else random
        self.overload = OV.resolve_controller(overload)
        self.fault_plan = fault_plan if fault_plan is not None else \
            getattr(engine, "fault_plan", None)
        # the packed-key budget is only a constraint for the v2 engine
        self._check_key_budget = \
            getattr(engine.session.config, "engine", None) != "v1"
        self.assembly_cache = AssemblyCache(assembly_cache_entries) \
            if assembly_cache_entries else None

        self._lock = threading.RLock()
        # serializes retirement of the in-flight FIFO head: the waiting
        # thread drops the lock during the device wait (so submit()
        # stays responsive) and this condition keeps a second retirer
        # from racing past it
        self._retire_cv = threading.Condition(self._lock)
        self._retiring = False
        self._closed = False
        self._queues: OrderedDict[int, deque] = OrderedDict()
        self._completed: deque[ServeResult] = deque()
        self._inflight: deque[_InFlight] = deque()   # global dispatch FIFO
        self._arenas: dict[tuple, _HostArena] = {}
        self._next_rid = 0
        self._next_dispatch = 0
        self._attempts: dict[int, int] = {}     # rid -> failed dispatches
        self._outstanding: dict[int, int] = {}  # bucket -> admitted, live
        self._coord_dim = None                  # first-seen stream widths
        self._feat_shape = None
        self._has_deadlines = False
        self._has_priorities = False
        # telemetry: every accumulator is a child of the shared metrics
        # registry (repro.obs), bound once here so the hot path pays one
        # attribute lookup + inc — stats() below is a bit-compatible
        # view over these children.  Tracer/recorder stay None unless
        # the caller opted in (Observability.enabled()).
        self.obs = obs if obs is not None else Observability()
        self.instance = str(instance)
        self._tracer = self.obs.tracer
        self._recorder = self.obs.recorder
        reg, inst = self.obs.registry, self.instance
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
        self._fam_scenes = reg.counter(
            "serve_scenes_total", "real scenes executed",
            ("instance", "bucket"))
        self._fam_batches = reg.counter(
            "serve_batches_total", "micro-batches executed",
            ("instance", "bucket"))
        self._fam_dummies = reg.counter(
            "serve_dummy_scenes_total", "dummy fill scenes executed",
            ("instance", "bucket"))
        self._m_buckets = {}            # cap -> (scenes, batches, dummies)
        self._c_points_real = reg.counter(
            "serve_points_real_total", "valid (unmasked) caller rows",
            ("instance",)).labels(inst)
        self._c_rows_issued = reg.counter(
            "serve_rows_issued_total", "bucket rows issued to the device",
            ("instance",)).labels(inst)
        self._c_deadline_flushes = reg.counter(
            "serve_deadline_flushes_total",
            "partial batches flushed by max_wait_s", ("instance",)).labels(inst)
        self._c_failed_dispatches = reg.counter(
            "serve_failed_dispatches_total",
            "micro-batch executions that raised", ("instance",)).labels(inst)
        self._c_retries = reg.counter(
            "serve_retries_total", "retry dispatches issued",
            ("instance",)).labels(inst)
        self._c_backoff = reg.counter(
            "serve_retry_backoff_seconds_total",
            "total time spent backing off before retries",
            ("instance",)).labels(inst)
        self._g_recovery = reg.gauge(
            "serve_recovery_seconds",
            "last failure -> next good retire", ("instance",)).labels(inst)
        self._h_latency = reg.histogram(
            "serve_request_latency_seconds",
            "submit -> predictions (OK results only)",
            ("instance",)).labels(inst)
        fam_errlat = reg.histogram(
            "serve_error_latency_seconds",
            "submit -> typed error result, by code", ("instance", "code"))
        self._h_errlat = {c: fam_errlat.labels(inst, c)
                          for c in FLT.ERROR_CODES}
        self._h_assembly = reg.histogram(
            "serve_assembly_seconds", "host assembly time per micro-batch",
            ("instance",)).labels(inst)
        self._h_queue_wait = reg.histogram(
            "serve_queue_wait_seconds", "admission -> dispatch",
            ("instance",)).labels(inst)
        reg.gauge("serve_queue_depth", "queued scenes (all buckets)",
                  ("instance",)).labels(inst).set_function(
            lambda: sum(len(q) for q in self._queues.values()))
        reg.gauge("serve_inflight_batches", "dispatched, un-retired slots",
                  ("instance",)).labels(inst).set_function(
            lambda: len(self._inflight))
        self._last_failure_t = None
        # trace bookkeeping (only touched when a tracer is wired in)
        self._rid_trace: dict[int, tuple[str, bool]] = {}  # rid->(tid,owned)
        self._qspans: dict[int, int] = {}    # rid -> open queue_wait span
        self._wspans: dict[int, int] = {}    # rid -> open device_wait span

        if self.overload is not None:
            self.overload.bind(self)

        if watchdog_s is None:
            if max_wait_s is not None:
                watchdog_s = max_wait_s / 4
            elif self.overload is not None:
                # the controller needs periodic ticks even when nobody
                # is polling — the estimator and the brownout ladder
                # both advance on the deadline sweep
                watchdog_s = self.overload.policy.tick_s
            else:
                watchdog_s = 0.0
        self._watchdog = FT.Ticker(
            max(_MIN_WATCHDOG_S, float(watchdog_s)), self._watchdog_tick,
            name="serve-watchdog") if watchdog_s > 0 else None

    def max_batch_for(self, cap: int) -> int:
        """Micro-batch width of one capacity bucket."""
        return self.max_batch_overrides.get(cap, self.max_batch)

    def _bucket_counters(self, cap: int):
        """(scenes, batches, dummy_scenes) counter children for one
        capacity bucket, bound on first dispatch into it."""
        m = self._m_buckets.get(cap)
        if m is None:
            b = str(cap)
            m = self._m_buckets[cap] = (
                self._fam_scenes.labels(self.instance, b),
                self._fam_batches.labels(self.instance, b),
                self._fam_dummies.labels(self.instance, b))
        return m

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Drain in-flight work and stop the watchdog.

        Queued scenes are executed (dummy-filled partial batches) and
        every in-flight micro-batch retires, so completed results stay
        drainable after close; the watchdog ticker thread is JOINED (no
        leaked daemon threads).  A chaos `FaultPlan` is closed first, so
        pending injected delays wake early and shutdown under chaos is
        prompt.  Idempotent; a submit after close completes with a
        `rejected` result instead of raising.
        """
        if self.fault_plan is not None:
            self.fault_plan.close()     # wake injected waits first
        wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.close()                  # join OUTSIDE the lock
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._expire_overdue_locked()
            for cap in list(self._queues):
                while self._queues[cap]:
                    self._run_bucket(cap)
            while self._retire_oldest_locked():
                pass
            if self.overload is not None:
                self.overload.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- admission --------------------------------------------------------

    def submit(self, coords, feats, mask=None,
               deadline_s: float | None = None,
               priority: int = 0,
               trace_id: str | None = None) -> int:
        """Admit one scene; returns its request id — ALWAYS.

        `coords` (N, 1+D) int32, `feats` (N, C); `mask` defaults to all
        rows valid.  The scene is validated up front (shapes, dtypes,
        finite features, packed-key budget, ladder fit — see
        `faults.validate_scene`); a scene that fails admission completes
        immediately with a `rejected` result under the returned rid
        instead of raising.  Accepted scenes are padded to the smallest
        ladder bucket holding N rows and queued with their bucket peers;
        a bucket that reaches its `max_batch` width dispatches
        immediately (async — the call returns while the micro-batch
        executes).  `deadline_s` bounds the QUEUE wait: a request still
        queued that long later completes with a `timeout` result (a
        request already dispatched runs to completion).  With
        `max_backlog`, a submit into a backed-up bucket completes with a
        `shed` result.  Thread-safe: padding and digesting happen
        outside the lock, so concurrent producers overlap their
        admission work.

        `priority` (default 0, higher = more urgent) picks the lane:
        when any nonzero priority has been seen — or an overload
        controller is attached and deadlines are in play — each
        micro-batch takes the highest-priority queued scenes first,
        earliest deadline first within a priority (EDF), FIFO within
        ties.  Only the queue ORDER changes; per-scene predictions are
        bit-identical.  Under brownout level 3 the lanes below the
        policy's `shed_below_priority` are shed at admission.

        `trace_id` attaches this request's spans to an EXISTING trace
        (a router began it before enqueueing); the scheduler then never
        ends that trace's root — the component that began it does.
        With no tracer wired in (the default) the argument is ignored.
        """
        t_submit = time.monotonic()
        if self.fault_plan is not None:
            coords, feats, mask = self.fault_plan.on_submit(
                coords, feats, mask)
        err = None
        n, cap = 0, -1
        if self.validate:
            try:
                coords, mask, feats, n, cap = FLT.validate_scene(
                    coords, feats, mask, self.ladder,
                    check_key_budget=self._check_key_budget,
                    coord_dim=self._coord_dim,
                    feat_shape=self._feat_shape)
            except FLT.AdmissionError as e:
                err = e.as_error()
        else:
            # no validation: a ladder overflow raises out of submit()
            coords = np.asarray(coords)
            n = coords.shape[0]
            if mask is None:
                mask = np.ones(n, bool)
            cap = self.ladder.bucket_for(n)
        if err is None:
            c, m, f = BK.pad_scene(coords, mask, feats, cap)
            key = self.engine.scene_key(c, m, cap)
            n_valid = int(np.asarray(mask, bool).sum())
            deadline = t_submit + deadline_s \
                if deadline_s is not None else None
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._c_submitted.inc()
            if err is None and self._closed:
                err = ServeError(FLT.REJECTED, "scheduler is closed")
            if err is None and self.max_backlog is not None and \
                    self._outstanding.get(cap, 0) >= self.max_backlog:
                ov = self.overload
                rate = ov.service_rate(cap) if ov is not None else None
                err = ServeError(
                    FLT.SHED,
                    f"bucket {cap} backlog at the max_backlog bound "
                    f"({self.max_backlog} outstanding scenes"
                    + (f"; observed service rate {rate:.1f} scenes/s"
                       if rate is not None else "") + ")",
                    retry_after_s=ov.retry_after(
                        cap, self._outstanding.get(cap, 0))
                    if ov is not None else None)
            if err is None and self.overload is not None:
                err = self.overload.check_admission_locked(
                    cap, self._outstanding.get(cap, 0), priority)
            tr = self._tracer
            if tr is not None:
                tid = trace_id if trace_id is not None else \
                    f"{self.instance}:rid:{rid}"
                tr.begin(tid, t=t_submit, rid=rid, instance=self.instance)
                self._rid_trace[rid] = (tid, trace_id is None)
                t_adm = time.monotonic()
                tr.span(tid, "admission", t_start=t_submit, t_end=t_adm,
                        bucket=cap, n_points=int(n))
            if self._recorder is not None:
                self._recorder.record("submit", rid=rid, bucket=int(cap),
                                      instance=self.instance,
                                      rejected=err is not None)
            if err is not None:
                self._complete_error_locked(rid, n, cap, t_submit, err)
                return rid
            if tr is not None:
                sid = tr.span(tid, "queue_wait", t_start=t_adm,
                              bucket=cap)
                if sid is not None:
                    self._qspans[rid] = sid
            if self._coord_dim is None:
                self._coord_dim = int(coords.shape[1])
                self._feat_shape = tuple(np.asarray(feats).shape[1:])
            req = ServeRequest(rid, c, m, f, n, n_valid, cap,
                               t_submit, key, deadline, int(priority))
            if deadline is not None:
                self._has_deadlines = True
            if priority:
                self._has_priorities = True
            self._outstanding[cap] = self._outstanding.get(cap, 0) + 1
            self._queues.setdefault(cap, deque()).append(req)
            if len(self._queues[cap]) >= self.max_batch_for(cap):
                if self.overload is None or self.pipeline_depth == 0 \
                        or not self._bucket_at_depth_locked(cap):
                    self._run_bucket(cap)
                # else: DEFERRED dispatch (controller mode) — the bucket
                # is at its pipeline depth, so the batch stays queued
                # until a slot retires (_pump_locked).  This is what
                # gives the priority/EDF lanes something to order and
                # the adaptive bound a real backlog to measure; the
                # uncontrolled scheduler dispatches immediately and
                # blocks in the depth overflow loop instead.
            self._check_deadlines_locked()
            return rid

    def poll(self) -> list[ServeResult]:
        """Non-blocking pipeline tick: deadline-flush overdue partial
        buckets, expire overdue requests, retire in-flight micro-batches
        whose results are already on host, and hand back everything
        completed so far."""
        with self._lock:
            self._check_deadlines_locked()
            while self._retire_oldest_locked(only_ready=True):
                pass
            if self._pump_locked():
                while self._retire_oldest_locked(only_ready=True):
                    pass
            out = list(self._completed)
            self._completed.clear()
            return out

    def flush(self) -> int:
        """Execute every queued scene (partial micro-batches are filled
        with masked dummy scenes), wait for everything in flight, and
        return how many scenes ran."""
        with self._lock:
            self._expire_overdue_locked()
            ran = 0
            for cap in list(self._queues):
                while self._queues[cap]:
                    ran += self._run_bucket(cap)
            while self._retire_oldest_locked():
                pass
            return ran

    def drain(self) -> list[ServeResult]:
        """Hand back every completed result, in completion order (NOT
        submission order — whichever bucket filled first ran first);
        waits for in-flight micro-batches."""
        with self._lock:
            while True:
                while self._retire_oldest_locked():
                    pass
                if not self._pump_locked():
                    break
            out = list(self._completed)
            self._completed.clear()
            return out

    def take(self, rids) -> dict[int, ServeResult]:
        """Pop completed results for `rids` only; anything else stays
        drainable (lets one caller collect its requests from a shared
        scheduler without discarding another caller's results).  Waits
        for in-flight micro-batches (the rids may be on one)."""
        with self._lock:
            while True:
                while self._retire_oldest_locked():
                    pass
                if not self._pump_locked():
                    break
            want = set(rids)
            out, keep = {}, deque()
            for r in self._completed:
                if r.rid in want:
                    out[r.rid] = r
                else:
                    keep.append(r)
            self._completed = keep
            return out

    def serve(self, scenes) -> dict[int, ServeResult]:
        """Convenience: submit an iterable of (coords, feats[, mask])
        scenes, flush, and return {rid: result} for THIS call's requests
        only — on a shared scheduler, other callers' results stay
        drainable/takeable."""
        rids = [self.submit(*scene) for scene in scenes]
        self.flush()
        return self.take(rids)

    # -- execution --------------------------------------------------------

    def _assemble(self, reqs, cap: int, mb: int, marks: dict = None):
        """Arena + composition-cache assembly: (hits, apply operands).

        coords/mask/feats are staged in the bucket's preallocated host
        arena (rotating slot, filled in place) and copied to the card;
        the tuple of the scenes' level pyramids (None for each dummy
        scene) and the device coords/mask, which the composition key
        fully determines, are served from the AssemblyCache when the
        ordered composition repeats, else gathered (and cached unless the
        cache is disabled).  Only
        feats is re-staged on a hit: it is the one operand the key does
        not cover (same geometry, fresh sensor payload).

        `marks` (tracing only) receives monotonic timestamps for the
        arena-staging and cache-lookup phases plus the hit flag.
        """
        n_real, n_dummy = len(reqs), mb - len(reqs)
        if marks is not None:
            marks["arena_t0"] = time.monotonic()
        arena = self._arenas.get((cap, mb))
        if arena is None:
            arena = self._arenas[(cap, mb)] = _HostArena(
                max(1, self.pipeline_depth), mb, cap,
                reqs[0].coords.shape[1], self.device)
        s = arena.next_slot(reqs[0].feats)
        for i, r in enumerate(reqs):
            arena.feats[s, i] = r.feats
        if n_dummy:                     # clear stale rows from fuller runs
            arena.feats[s, n_real:] = 0
        feats_b = arena.to_device("feats", s)

        comp_key = (cap, mb, n_dummy, tuple(r.key for r in reqs))
        if marks is not None:
            marks["lookup_t0"] = time.monotonic()
        cached = self.assembly_cache.lookup(comp_key) \
            if self.assembly_cache is not None else None
        if cached is not None:
            # the whole batch is reused: every scene's mapping work was
            # skipped wholesale, so each request reports a hit (the
            # per-scene MappingCache is bypassed, not consulted)
            levels_b, coords_b, mask_b = cached
            hits = [True] * n_real
        else:
            for i, r in enumerate(reqs):
                arena.coords[s, i] = r.coords
                arena.mask[s, i] = r.mask
            if n_dummy:
                arena.coords[s, n_real:] = M.SENTINEL
                arena.mask[s, n_real:] = False
            coords_b = arena.to_device("coords", s)
            mask_b = arena.to_device("mask", s)
            per = [self.engine._levels_padded(r.coords, r.mask, cap,
                                              key=r.key) for r in reqs]
            hits = [h for _, h in per]
            levels_b = tuple(lv for lv, _ in per) + (None,) * n_dummy
            if self.assembly_cache is not None:
                self.assembly_cache.put(comp_key,
                                        (levels_b, coords_b, mask_b))
        arena.shipped(s)
        if marks is not None:
            marks["lookup_t1"] = time.monotonic()
            marks["cache_hit"] = cached is not None
        return hits, (levels_b, coords_b, mask_b, feats_b)

    def _bucket_at_depth_locked(self, cap: int) -> bool:
        """Is this bucket's in-flight slot count at its pipeline depth?
        (The same bound the uncontrolled depth-overflow loop enforces by
        blocking — controller mode enforces it by deferring dispatch.)"""
        return sum(1 for slot in self._inflight if slot.cap == cap) \
            > self.pipeline_depth

    def _pump_locked(self) -> int:
        """Dispatch deferred full batches that now fit their bucket's
        pipeline depth (controller mode only — without a controller
        submit never defers).  Returns how many scenes were dispatched;
        callers that just retired slots loop until this returns 0."""
        if self.overload is None or self.pipeline_depth == 0:
            return 0
        ran = 0
        for cap in list(self._queues):
            q = self._queues[cap]
            while len(q) >= self.max_batch_for(cap) and \
                    not self._bucket_at_depth_locked(cap):
                ran += self._run_bucket(cap)
        return ran

    def _lane_order_enabled(self) -> bool:
        """Priority/EDF queue ordering is live once any nonzero
        priority has been submitted, or an overload controller is
        attached and deadlines are in play.  Plain FIFO streams (the
        default) never enter the reorder path — bit-identical
        dispatch composition."""
        return self._has_priorities or \
            (self.overload is not None and self._has_deadlines)

    def _run_bucket(self, cap: int) -> int:
        """Pop up to max_batch queued scenes and dispatch them (caller
        holds the lock).  With priority lanes active the pop takes the
        highest-priority scenes first, earliest deadline first within a
        priority (EDF), FIFO within ties — the micro-batch SHAPE and
        each scene's predictions are unchanged, only which queued
        scenes go first."""
        q = self._queues[cap]
        mb = self.max_batch_for(cap)
        take = min(mb, len(q))
        if take > 1 and len(q) > take and self._lane_order_enabled():
            items = list(q)
            chosen = sorted(
                range(len(items)),
                key=lambda i: (-items[i].priority,
                               items[i].deadline
                               if items[i].deadline is not None
                               else math.inf, i))[:take]
            picked = set(chosen)
            reqs = [items[i] for i in sorted(picked)]
            q.clear()
            q.extend(items[i] for i in range(len(items))
                     if i not in picked)
        else:
            reqs = [q.popleft() for _ in range(take)]
        if not reqs:
            return 0
        return self._dispatch(reqs, cap, retries=0)

    def _dispatch(self, reqs, cap: int, retries: int) -> int:
        """Assemble + dispatch one micro-batch (caller holds the lock).

        Dispatch is asynchronous: the engine's micro-batch call enqueues
        its work, the labels' copy to pinned host memory and an event,
        and the slot is parked on the in-flight FIFO; completion happens
        in drain()/poll()/flush()/take() (or the watchdog).
        Once a bucket exceeds `pipeline_depth` in-flight slots the
        oldest slots retire first (double buffering) — with depth 0 the
        batch retires immediately (synchronous execution).  Retry
        dispatches (`retries > 0`) run partial batches at the SAME
        (max_batch, capacity) shape with dummy fill, so failure recovery
        adds no new shape.  A dispatch that raises on the
        spot (assembly or launch) goes straight to the failure-isolation
        path instead of propagating.
        """
        mb = self.max_batch_for(cap)
        n_real = len(reqs)
        did = self._next_dispatch
        self._next_dispatch += 1
        if retries:
            self._c_retries.inc()
        tr = self._tracer
        t_disp = time.monotonic()
        marks = {} if tr is not None else None
        try:
            with self._on_device():
                t0 = time.perf_counter()
                hits, operands = self._assemble(reqs, cap, mb, marks)
                t1 = time.perf_counter()
                self._h_assembly.observe(t1 - t0)
                preds, done = _labels_to_host(self._apply(*operands))
        except Exception as e:
            self._on_slot_failed(
                _InFlight(cap, list(reqs), [False] * n_real, None,
                          did, retries), e)
            return n_real
        if tr is not None:
            self._trace_dispatch(reqs, did, cap, retries, t_disp, marks)
        if self._recorder is not None:
            self._recorder.record(
                "dispatch", dispatch_id=did, bucket=int(cap),
                n_real=n_real, retries=retries,
                rids=[r.rid for r in reqs], instance=self.instance)
        self._inflight.append(_InFlight(cap, list(reqs), hits, preds,
                                        did, retries, done))

        m_scenes, m_batches, m_dummies = self._bucket_counters(cap)
        self._c_points_real.inc(sum(r.n_valid for r in reqs))
        self._c_rows_issued.inc(mb * cap)
        m_scenes.inc(n_real)
        m_batches.inc()
        m_dummies.inc(mb - n_real)
        for r in reqs:
            self._h_queue_wait.observe(t_disp - r.t_submit)

        if self.pipeline_depth == 0:
            while self._retire_oldest_locked():
                pass
        elif self.overload is None:
            # double buffering: once this bucket exceeds its depth, pay
            # for the FIFO head (possibly an older bucket's slot — see
            # _retire_oldest_locked) until the bucket is back in budget
            while sum(1 for slot in self._inflight if slot.cap == cap) \
                    > self.pipeline_depth:
                self._retire_oldest_locked()
        # else: controller mode bounds depth at ADMISSION (deferred
        # dispatch in submit) instead of blocking here — retirement
        # belongs to poll()/flush()/take()/the watchdog, so submit never
        # sits in a device wait and the deferral decision is
        # deterministic (only a deadline flush can transiently exceed
        # the depth)
        return n_real

    def _trace_dispatch(self, reqs, did: int, cap: int, retries: int,
                        t_disp: float, marks: dict | None) -> None:
        """Per-request dispatch spans (caller holds the lock, tracer is
        wired in): close the queue_wait span, record the dispatch span
        with its assembly children, open the device_wait span."""
        tr = self._tracer
        t_launch = time.monotonic()
        for r in reqs:
            tid_owned = self._rid_trace.get(r.rid)
            if tid_owned is None:
                continue
            tid = tid_owned[0]
            tr.end_span(tid, self._qspans.pop(r.rid, None), t_end=t_disp)
            dspan = tr.span(tid, "dispatch", t_start=t_disp,
                            t_end=t_launch, dispatch_id=did,
                            bucket=cap, retries=retries)
            if marks:
                aspan = tr.span(tid, "assembly", parent=dspan,
                                t_start=marks["arena_t0"],
                                t_end=marks["lookup_t1"],
                                cache_hit=marks["cache_hit"])
                tr.span(tid, "arena_staging", parent=aspan,
                        t_start=marks["arena_t0"],
                        t_end=marks["lookup_t0"])
                tr.span(tid, "assembly_lookup", parent=aspan,
                        t_start=marks["lookup_t0"],
                        t_end=marks["lookup_t1"])
            sid = tr.span(tid, "device_wait", t_start=t_launch,
                          dispatch_id=did)
            if sid is not None:
                self._wspans[r.rid] = sid

    def _on_device(self):
        """The engine's CUDA device as the current one (dispatch may run
        on any thread); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _wait_slot(self, slot: _InFlight) -> np.ndarray:
        """Block for one slot's labels (runs WITHOUT the lock).  The fault
        plan's wait seam lives here: an injected delay or failure behaves
        exactly like a slow or crashing device."""
        if self.fault_plan is not None:
            self.fault_plan.check_wait(slot.dispatch_id, slot.cap,
                                       [r.rid for r in slot.reqs])
        if slot.done is not None:
            slot.done.synchronize()
        return slot.preds.numpy()

    def _on_slot_failed(self, slot: _InFlight, exc: BaseException) -> None:
        """Failure isolation (caller holds the lock): a failed
        micro-batch never re-enters the FIFO to poison later retires.

        Every real request on the slot gets another chance as a fresh
        dispatch — bisected into halves when the batch held several
        scenes (`retry_bisect`), so a single poison scene is isolated in
        O(log max_batch) rounds while its neighbours complete normally —
        and a request that has exhausted its `max_retries` re-dispatch
        budget completes with a typed `exec_failed` result.  The
        scheduler keeps serving either way.
        """
        self._c_failed_dispatches.inc()
        self._last_failure_t = time.monotonic()
        if self.overload is not None:
            self.overload.record_dispatch_failure(slot.cap)
        if self._tracer is not None:
            for r in slot.reqs:
                tid_owned = self._rid_trace.get(r.rid)
                if tid_owned is not None:
                    tid = tid_owned[0]
                    self._tracer.end_span(
                        tid, self._wspans.pop(r.rid, None),
                        t_end=self._last_failure_t, failed=True)
                    self._tracer.event(
                        tid, "dispatch_failed", t=self._last_failure_t,
                        dispatch_id=slot.dispatch_id, error=repr(exc))
        if self._recorder is not None:
            self._recorder.record(
                "dispatch_failed", dispatch_id=slot.dispatch_id,
                bucket=int(slot.cap), rids=[r.rid for r in slot.reqs],
                retries=slot.retries, error=repr(exc),
                instance=self.instance)
        retryable, dead = [], []
        for r in slot.reqs:
            a = self._attempts.get(r.rid, 0) + 1
            self._attempts[r.rid] = a
            (retryable if a <= self.max_retries else dead).append(r)
        for r in dead:
            self._attempts.pop(r.rid, None)
            self._outstanding[slot.cap] = \
                self._outstanding.get(slot.cap, 1) - 1
            self._complete_error_locked(
                r.rid, r.n_points, slot.cap, r.t_submit,
                ServeError(FLT.EXEC_FAILED,
                           f"micro-batch execution failed "
                           f"{self.max_retries + 1}x; last error: {exc}"))
        if not retryable:
            return
        self._backoff_locked(slot.retries)
        if len(retryable) > 1 and self.retry_bisect:
            mid = (len(retryable) + 1) // 2
            groups = (retryable[:mid], retryable[mid:])
        else:
            groups = (retryable,)
        for group in groups:
            self._dispatch(group, slot.cap, slot.retries + 1)

    def _backoff_locked(self, generation: int) -> None:
        """Jittered exponential backoff before a retry dispatch (the
        `retry_backoff_s` knob; 0 — the default — keeps retries
        immediate).  The retried requests live only on this call's
        stack, so the lock is safe to release for the wait: producers
        keep admitting scenes, and nothing can re-dispatch the failed
        slot's requests concurrently."""
        if self.retry_backoff_s <= 0 or self._closed:
            return
        delay = self.retry_backoff_s * (2 ** generation) \
            * (0.5 + self._rng.random())
        self._c_backoff.inc(delay)
        self._lock.release()
        try:
            time.sleep(delay)
        finally:
            self._lock.acquire()

    def _retire_oldest_locked(self, only_ready: bool = False) -> bool:
        """Retire the OLDEST in-flight micro-batch; returns False when
        there is nothing (eligible) to retire.

        FIFO retirement keeps completion order = dispatch order, like
        the synchronous scheduler — even when one bucket's depth
        overflow pays for older buckets' slots first (they were
        dispatched earlier, so waiting on them in order is the bound on
        total in-flight memory, not an accident).  The lock is RELEASED
        during the device wait so producer threads can keep admitting
        scenes; `_retiring` serializes retirers on the FIFO head.  With
        `only_ready` the call never blocks: it retires only a head whose
        result is already on host (poll()'s non-blocking tick).

        A wait that raises resolves the slot through the
        failure-isolation path (`_on_slot_failed`: retry / bisect /
        `exec_failed` results) — the slot is NOT re-queued, so one
        failed execution can never poison every later retire.  Only
        BaseExceptions that aren't Exceptions (KeyboardInterrupt,
        SystemExit) re-queue the slot and propagate.

        Caller must hold the lock exactly once (every public entry point
        acquires it with one `with self._lock:` and internal helpers
        never re-enter), so the release/re-acquire below fully drops it.
        """
        if only_ready and self._retiring:
            return False                # a blocking retirer owns the head
        while self._retiring:
            self._retire_cv.wait()
        if not self._inflight:
            return False
        if only_ready and not self._inflight[0].ready():
            return False
        slot = self._inflight.popleft()
        self._retiring = True
        self._lock.release()
        failure = None
        try:
            preds = self._wait_slot(slot)
        except Exception as e:
            failure = e
        except BaseException:
            self._lock.acquire()
            self._retiring = False
            # interpreter-level interrupt: put the slot back at the head
            # so its requests stay addressable, and propagate
            self._inflight.appendleft(slot)
            self._retire_cv.notify_all()
            raise
        self._lock.acquire()
        self._retiring = False
        self._retire_cv.notify_all()
        if failure is not None:
            self._on_slot_failed(slot, failure)
            return True                 # the slot WAS resolved
        t_done = time.monotonic()
        if self._last_failure_t is not None:
            self._g_recovery.set(t_done - self._last_failure_t)
            self._last_failure_t = None
        if self.overload is not None:
            self.overload.record_dispatch_success(slot.cap,
                                                  len(slot.reqs))
        tr = self._tracer
        for i, r in enumerate(slot.reqs):
            lat = t_done - r.t_submit
            self._attempts.pop(r.rid, None)
            self._outstanding[slot.cap] = \
                self._outstanding.get(slot.cap, 1) - 1
            self._completed.append(ServeResult(
                r.rid, preds[i, :r.n_points].astype(np.int32), r.n_points,
                slot.cap, 1.0 - r.n_valid / slot.cap, bool(slot.hits[i]),
                lat))
            self._h_latency.observe(lat)
            if tr is not None:
                tid_owned = self._rid_trace.pop(r.rid, None)
                if tid_owned is not None:
                    tid, owned = tid_owned
                    tr.end_span(tid, self._wspans.pop(r.rid, None),
                                t_end=t_done)
                    tr.event(tid, "retire", t=t_done,
                             dispatch_id=slot.dispatch_id)
                    if owned:
                        tr.end(tid, t=t_done, outcome="ok")
        if self._recorder is not None:
            self._recorder.record(
                "retire", dispatch_id=slot.dispatch_id,
                bucket=int(slot.cap), rids=[r.rid for r in slot.reqs],
                instance=self.instance)
        self._c_completed.inc(len(slot.reqs))
        self._c_ok.inc(len(slot.reqs))
        return True

    # -- failure completion / deadlines -----------------------------------

    def _complete_error_locked(self, rid: int, n_points: int, bucket: int,
                               t_submit: float, err: ServeError) -> None:
        """Terminate one request with a typed error result.

        The latency lands in the per-code error histogram — the average
        only ever covered OK results, so shed/timeout/exec_failed wait
        times used to vanish from telemetry entirely."""
        now = time.monotonic()
        lat = now - t_submit
        self._completed.append(ServeResult(
            rid, None, int(n_points), int(bucket), 0.0, False, lat, err))
        self._c_completed.inc()
        self._c_faults[err.code].inc()
        self._h_errlat[err.code].observe(lat)
        if self._tracer is not None:
            tid_owned = self._rid_trace.pop(rid, None)
            if tid_owned is not None:
                tid, owned = tid_owned
                self._tracer.end_span(tid, self._qspans.pop(rid, None),
                                      t_end=now)
                self._wspans.pop(rid, None)
                self._tracer.event(tid, "error", t=now, code=err.code,
                                   message=err.message)
                if owned:
                    self._tracer.end(tid, t=now, outcome=err.code)
        if self._recorder is not None:
            self._recorder.record("error", rid=rid, code=err.code,
                                  bucket=int(bucket),
                                  instance=self.instance)
            if err.code == FLT.EXEC_FAILED:
                self._recorder.dump("exec_failed",
                                    key=("exec_failed", self.instance, rid))

    def _expire_overdue_locked(self) -> None:
        """Convert queued requests whose `deadline_s` elapsed into
        `timeout` results (a dispatched request runs to completion —
        device work cannot be cancelled)."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        live = 0
        for cap in list(self._queues):
            q = self._queues[cap]
            if any(r.deadline is not None for r in q):
                keep = deque()
                for r in q:
                    if r.deadline is not None and now >= r.deadline:
                        self._attempts.pop(r.rid, None)
                        self._outstanding[cap] = \
                            self._outstanding.get(cap, 1) - 1
                        self._complete_error_locked(
                            r.rid, r.n_points, cap, r.t_submit,
                            ServeError(
                                FLT.TIMEOUT,
                                f"deadline_s exceeded after "
                                f"{now - r.t_submit:.3f}s in queue",
                                retry_after_s=self.overload.retry_after(
                                    cap, self._outstanding.get(cap, 0))
                                if self.overload is not None else None))
                    else:
                        keep.append(r)
                self._queues[cap] = keep
            live += sum(1 for r in self._queues[cap]
                        if r.deadline is not None)
        self._has_deadlines = live > 0

    def _check_deadlines_locked(self, from_watchdog: bool = False) -> None:
        """Deadline policies: expire overdue requests (`deadline_s` ->
        `timeout` results), then the max_wait_s flush — a partial
        micro-batch executes once its oldest queued request exceeds the
        batching deadline.  A WATCHDOG-fired flush also snapshots the
        flight recorder: nobody was polling, so the ring around the
        stall is the evidence worth keeping.  The overload controller
        ticks here too (rate re-estimation + brownout ladder) — this
        sweep runs from submit()/poll() and the watchdog, so the
        control loop advances with traffic and on idle schedulers
        alike."""
        if self.overload is not None:
            self.overload.maybe_tick()
        self._expire_overdue_locked()
        if self.max_wait_s is None:
            return
        now = time.monotonic()
        for cap in list(self._queues):
            q = self._queues[cap]
            if q and now - q[0].t_submit >= self.max_wait_s:
                self._c_deadline_flushes.inc()
                if self._recorder is not None:
                    self._recorder.record(
                        "deadline_flush", bucket=int(cap),
                        queued=len(q), from_watchdog=from_watchdog,
                        instance=self.instance)
                    if from_watchdog:
                        self._recorder.dump(
                            "watchdog_deadline_flush",
                            key=("wd_flush", self.instance,
                                 int(self._c_deadline_flushes.value)))
                self._run_bucket(cap)

    def _watchdog_tick(self) -> None:
        """Background completion (the `watchdog_s` Ticker): fire
        `max_wait_s` deadline flushes, expire per-request deadlines, and
        retire already-ready slots on an idle scheduler — so results
        complete without anyone calling poll(), and poll() itself stays
        constant-time."""
        with self._lock:
            if self._closed:
                return
            self._check_deadlines_locked(from_watchdog=True)
            while self._retire_oldest_locked(only_ready=True):
                pass
            if self._pump_locked():
                while self._retire_oldest_locked(only_ready=True):
                    pass

    # -- telemetry --------------------------------------------------------

    def service_rate(self, cap: int) -> float | None:
        """Observed EWMA service rate (scenes/s) for one bucket — None
        without an overload controller or before it has an estimate."""
        with self._lock:
            return self.overload.service_rate(cap) \
                if self.overload is not None else None

    def retry_after_hint(self) -> float | None:
        """Aggregate backpressure hint: estimated seconds until this
        scheduler's outstanding work drains at the observed completion
        rate (what a router aggregates across workers for a pool-level
        shed).  None without an overload controller."""
        with self._lock:
            return self.overload.retry_after_hint() \
                if self.overload is not None else None

    def stats(self) -> dict:
        """Serving telemetry: padding overhead, mapping + assembly cache
        hit rates, assembly time, per-bucket occupancy, deadline flushes,
        pipeline state, compile counts, latency, and the fault counters
        (rejected / shed / timeout / exec_failed, failed dispatches,
        retries, last failure->recovery time).  `scheduler_max_backlog`
        is the PER-BUCKET admission bound (the router's per-worker bound
        surfaces as `router_max_backlog` in ITS stats())."""
        with self._lock:
            buckets = {}
            for cap, (m_scenes, m_batches, m_dummies) in \
                    self._m_buckets.items():
                issued = m_scenes.value + m_dummies.value
                buckets[int(cap)] = {
                    "scenes": m_scenes.value,
                    "batches": m_batches.value,
                    "dummy_scenes": m_dummies.value,
                    "occupancy": (m_scenes.value / issued
                                  if issued else 0.0),
                    "max_batch": self.max_batch_for(cap),
                }
            real_points = self._c_points_real.value
            overhead = (self._c_rows_issued.value / real_points - 1.0) \
                if real_points else 0.0
            n_batches = self._h_assembly.count
            assembly_s = self._h_assembly.sum
            h_lat = self._h_latency
            return {
                "n_submitted": self._c_submitted.value,
                "n_completed": self._c_completed.value,
                "n_ok": self._c_ok.value,
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "in_flight": len(self._inflight),
                "padding_overhead": overhead,
                "mapping_cache": self.engine.cache_stats(),
                "assembly_cache": (self.assembly_cache.stats()
                                   if self.assembly_cache else None),
                "assembly_time_s": assembly_s,
                "assembly_time_per_batch_s": (assembly_s / n_batches
                                              if n_batches else 0.0),
                "deadline_flushes": self._c_deadline_flushes.value,
                "buckets": buckets,
                "max_batch": self.max_batch,
                "max_batch_overrides": dict(self.max_batch_overrides),
                "scheduler_max_backlog": self.max_backlog,
                "pipeline_depth": self.pipeline_depth,
                "n_devices": (self.mesh.size if self.mesh is not None
                              else 1),
                "compiles": {k: v for k, v in
                             self.engine.compile_stats().items()
                             if k in ("build", "apply_batch")},
                "latency_avg_s": (h_lat.sum / h_lat.count
                                  if h_lat.count else 0.0),
                "latency_quantiles_s": h_lat.quantiles(),
                "faults": {
                    **{c: m.value for c, m in self._c_faults.items()},
                    "failed_dispatches": self._c_failed_dispatches.value,
                    "retries": self._c_retries.value,
                    "retry_backoff_s": float(self._c_backoff.value),
                    "recovery_s": self._g_recovery.value,
                },
                "watchdog": self._watchdog is not None,
                "closed": self._closed,
            }
