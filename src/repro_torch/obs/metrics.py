"""Unified metrics registry for the serving stack: labeled counters,
gauges, and fixed-bucket histograms behind every `stats()` dict.

PointAcc's design method is measurement-first: the paper's CPU/GPU
bottleneck breakdown is what motivates the mapping-kernel and fusion
hardware.  Our serving stack needs the same discipline one level up —
but until this module, each component (scheduler, router, fault plan,
engine) accumulated its own ad-hoc `_latency_sum`/`_n_*` fields with
overlapping-but-drifting names, averages hid tail latency, and nothing
could be exported.  `MetricsRegistry` replaces those fields:

  * every serve-side telemetry value is a **Counter**, **Gauge**, or
    **Histogram** registered under one canonical name with explicit
    labels (`instance` distinguishes schedulers/routers/workers sharing
    one registry; `bucket`/`code` label per-capacity and per-error-code
    series);
  * the legacy `stats()` dicts are now *views* over the registry —
    bit-compatible key for key, value for value (float accumulation
    order preserved), so nothing downstream changes;
  * histograms carry fixed bucket bounds + exact sum/count, so p50/p95/
    p99 come from `Histogram.quantile` instead of averages-only, and the
    whole registry snapshots to Prometheus text exposition
    (`repro_torch.obs.export.prometheus_text`).

Thread-safety: child creation is locked; child *mutation* (`inc`,
`set`, `observe`) is plain attribute arithmetic and must happen under
the owning component's lock — exactly where the ad-hoc fields were
mutated before — or from a single thread.  Components sharing a
registry bind disjoint label sets (distinct `instance` values), so
their children never alias.

Canonical serve metric schema (the one source of truth — the README
"Observability" table renders this list):

  counter  serve_requests_submitted_total{instance}
  counter  serve_requests_completed_total{instance}
  counter  serve_requests_ok_total{instance}
  counter  serve_faults_total{instance,code}      code in ERROR_CODES
  counter  serve_scenes_total{instance,bucket}    real scenes executed
  counter  serve_batches_total{instance,bucket}   micro-batches executed
  counter  serve_dummy_scenes_total{instance,bucket}
  counter  serve_points_real_total{instance}      valid caller rows
  counter  serve_rows_issued_total{instance}      bucket rows to device
  counter  serve_deadline_flushes_total{instance}
  counter  serve_failed_dispatches_total{instance}
  counter  serve_retries_total{instance}
  counter  serve_retry_backoff_seconds_total{instance}
  counter  serve_failovers_total{instance}        router only
  counter  serve_replays_total{instance}          router only
  gauge    serve_queue_depth{instance}            lazy (set_function)
  gauge    serve_inflight_batches{instance}       lazy (set_function)
  gauge    serve_recovery_seconds{instance}       last failure->recovered
  gauge    serve_overload_state{instance}         brownout level (0=nominal)
  gauge    serve_effective_backlog{instance,bucket}  adaptive shed bound
  gauge    serve_breaker_state{instance,target}   0 closed/1 half-open/2 open
  histo    serve_request_latency_seconds{instance}   OK results only
  histo    serve_error_latency_seconds{instance,code} submit->typed error
  histo    serve_assembly_seconds{instance}       per micro-batch
  histo    serve_queue_wait_seconds{instance}     admission->dispatch

The legacy `stats()` keys map onto it 1:1 (`SCHEDULER_STATS_KEYS` /
`ROUTER_STATS_KEYS` below freeze the dict shapes; a schema-shape test
keeps future keys from silently forking the two views again):

  n_submitted       = serve_requests_submitted_total
  n_completed       = serve_requests_completed_total
  n_ok              = serve_requests_ok_total
  latency_avg_s     = latency histogram sum / count   (OK only — error
                      paths land in serve_error_latency_seconds, which
                      the averages silently dropped before)
  faults.<code>     = serve_faults_total{code=<code>}
  buckets.<cap>.*   = serve_{scenes,batches,dummy_scenes}_total{bucket}
  padding_overhead  = rows_issued / points_real - 1
  assembly_time_s   = serve_assembly_seconds sum
"""

from __future__ import annotations

import bisect
import threading

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# seconds; spans ~0.1 ms .. 10 s — the serve latency range from a warm
# micro-batch on small buckets up to a cold compile
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# -- frozen stats() shapes (schema-shape tests import these) ---------------

SCHEDULER_STATS_KEYS = frozenset({
    "n_submitted", "n_completed", "n_ok", "queue_depth", "in_flight",
    "padding_overhead", "mapping_cache", "assembly_cache",
    "assembly_time_s", "assembly_time_per_batch_s", "deadline_flushes",
    "buckets", "max_batch", "max_batch_overrides",
    "scheduler_max_backlog", "pipeline_depth",
    "n_devices", "compiles", "latency_avg_s", "latency_quantiles_s",
    "faults", "watchdog", "closed",
})
SCHEDULER_BUCKET_KEYS = frozenset({
    "scenes", "batches", "dummy_scenes", "occupancy", "max_batch",
})
SCHEDULER_FAULT_KEYS = frozenset({
    "rejected", "shed", "timeout", "exec_failed", "failed_dispatches",
    "retries", "retry_backoff_s", "recovery_s",
})
ROUTER_STATS_KEYS = frozenset({
    "n_workers", "n_live", "workers", "n_submitted", "n_completed",
    "n_ok", "routed_incomplete", "latency_avg_s", "latency_quantiles_s",
    "pool_cache", "faults", "liveness", "max_replays", "max_backlog",
    "router_max_backlog", "closed",
})
ROUTER_FAULT_KEYS = frozenset({
    "rejected", "shed", "timeout", "exec_failed", "failovers",
    "replayed", "recovery_s",
})
# the quantile view every latency-reporting stats() exposes
LATENCY_QUANTILES = (0.5, 0.95, 0.99)


class Counter:
    """Monotonic sum.  `inc` under the owning component's lock."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    """Point-in-time value; `set_function` makes it lazily evaluated at
    snapshot time (queue depths and similar derived lengths)."""

    __slots__ = ("_value", "_fn")

    def __init__(self):
        self._value = None
        self._fn = None

    def set(self, v):
        self._value = v

    def inc(self, n=1):
        self._value = (self._value or 0) + n

    def dec(self, n=1):
        self.inc(-n)

    def set_function(self, fn):
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return None
        return self._value


class Histogram:
    """Fixed-bucket histogram with exact sum/count.

    `bounds` are inclusive upper bucket bounds; an implicit +Inf bucket
    catches the tail.  `sum` accumulates observations in arrival order,
    so a legacy `_x_sum += v` field replaced by `observe(v)` stays
    bit-identical.  `quantile(q)` linearly interpolates inside the
    owning bucket (the standard Prometheus `histogram_quantile`
    estimate): resolution is the bucket width, which the default serve
    bounds keep within ~2.5x at any latency decade.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing, got {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1); 0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                if i >= len(self.bounds):        # +Inf bucket: clamp
                    return self.bounds[-1] if self.bounds else 0.0
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * max(0.0, rank - acc) / c
            acc += c
        return self.bounds[-1] if self.bounds else 0.0

    def quantiles(self, qs=LATENCY_QUANTILES) -> dict:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}


_KINDS = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class Family:
    """One named metric family: a child per label-value tuple.

    `labels(*values)` returns (creating on first use) the child for one
    label-value tuple; an unlabeled family has exactly one child at the
    empty tuple, and proxies `inc`/`set`/`observe` straight to it.
    """

    def __init__(self, kind: str, name: str, help: str = "",
                 labelnames=(), buckets=DEFAULT_LATENCY_BUCKETS):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._children: dict = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self.labels()               # eager default child

    def _make_child(self):
        if self.kind == HISTOGRAM:
            return Histogram(self.buckets)
        return _KINDS[self.kind]()

    def labels(self, *values):
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{values}")
        key = tuple(values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def items(self, **match):
        """[(label_values_tuple, child)] sorted by labels; `match`
        filters on named label positions (e.g. instance='w0')."""
        idx = {n: i for i, n in enumerate(self.labelnames)}
        for name in match:
            if name not in idx:
                raise ValueError(f"{self.name} has no label {name!r}")
        out = [(k, c) for k, c in sorted(self._children.items(),
                                         key=lambda kv: str(kv[0]))
               if all(k[idx[n]] == v for n, v in match.items())]
        return out

    # unlabeled-family conveniences
    def inc(self, n=1):
        self.labels().inc(n)

    def dec(self, n=1):
        self.labels().dec(n)

    def set(self, v):
        self.labels().set(v)

    def observe(self, v):
        self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value


class MetricsRegistry:
    """Get-or-create registry of metric families.

    Re-registering a name is idempotent when the kind/labelnames agree
    (components sharing a registry declare the same families) and a
    loud error when they do not — the schema cannot silently fork.
    """

    def __init__(self):
        self._families: dict[str, Family] = {}
        self._lock = threading.Lock()

    def _get(self, kind, name, help, labelnames, buckets):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(kind, name, help, labelnames, buckets)
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames}; cannot re-register as {kind} "
                f"with labels {tuple(labelnames)}")
        return fam

    def counter(self, name, help="", labelnames=()):
        return self._get(COUNTER, name, help, labelnames, ())

    def gauge(self, name, help="", labelnames=()):
        return self._get(GAUGE, name, help, labelnames, ())

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        return self._get(HISTOGRAM, name, help, labelnames, buckets)

    def collect(self):
        """Families in registration order (export + schema tests)."""
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        """{name: {labels_tuple_repr: value-or-histogram-dict}} — a
        plain-data view for JSON dumps and assertions."""
        out = {}
        for fam in self.collect():
            series = {}
            for lv, child in fam.items():
                key = ",".join(f"{n}={v}" for n, v in
                               zip(fam.labelnames, lv)) or ""
                if fam.kind == HISTOGRAM:
                    series[key] = {"sum": child.sum, "count": child.count,
                                   "buckets": dict(zip(
                                       [*map(str, child.bounds), "+Inf"],
                                       child.counts))}
                else:
                    series[key] = child.value
            out[fam.name] = {"kind": fam.kind, "series": series}
        return out
