"""Request span tracing for the serving stack.

One serve request crosses many stages — admission, bucket queue,
assembly, device dispatch, retire, and (multi-worker / city-scale) a
router hop, failover replay, or partition fan-out — and the aggregate
metrics can say *that* p99 moved without saying *where*.  `SpanTracer`
answers "where did this request's 40 ms go": every request id owns a
**span tree** under one trace, each span carrying monotonic start/end
timestamps and small attribute dicts, so a single trace reconstructs the
request's whole path:

    request (root)                          rid=3 instance=w1
    ├─ route          0.00ms → 0.04ms       worker=w1      (router only)
    ├─ admission      0.04ms → 0.21ms       bucket=512
    ├─ queue_wait     0.21ms → 3.90ms       bucket=512
    ├─ dispatch       3.90ms → 5.10ms       dispatch_id=7 retries=0
    │  └─ assembly    3.90ms → 4.60ms       cache_hit=True
    │     ├─ arena_staging     3.90 → 4.1
    │     └─ assembly_lookup   4.1  → 4.2
    ├─ device_wait    5.10ms → 38.7ms
    └─ retire         38.7ms                (instant)

Failure paths appear as spans too: `dispatch_failed`, `failover`
(attrs: dead worker + reason), `replay` (attrs: surviving worker) — so a
chaos-run trace shows original dispatch → failover → replay → retire in
one tree.

Design constraints (the ≤3% overhead gate in `bench_serve
serve/obs_overhead` is asserted against this implementation):

  * recording a span is one dict + one list append under a leaf lock —
    no I/O, no string formatting on the hot path;
  * the tracer is OPTIONAL: every seam in the scheduler/router is gated
    on `tracer is not None`, and the disabled path is bit-identical;
  * finished traces park in a bounded deque (`max_finished`) — a
    long-running server never grows without bound; exporters drain or
    snapshot them (`repro_torch.obs.export.write_trace_jsonl`).

Trace ids are plain strings.  The component that BEGINS a trace owns
its root (and ends it); components handed a `trace_id` (a router's
worker scheduler, a partition plan's chunk submits) attach child spans
to the existing tree without touching the root.
"""

from __future__ import annotations

import threading
import time
from collections import deque

DEFAULT_MAX_FINISHED = 4096


class Span:
    __slots__ = ("span_id", "parent_id", "name", "t_start", "t_end",
                 "attrs")

    def __init__(self, span_id, parent_id, name, t_start, t_end=None,
                 attrs=None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.t_end = t_end
        self.attrs = attrs or {}

    def as_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t_start": self.t_start,
                "t_end": self.t_end, "attrs": dict(self.attrs)}


class Trace:
    """One request's span tree: a root span plus children, keyed by
    span id.  `closed` means the root ended — the request completed
    (with predictions or a typed error) and the tree is final."""

    __slots__ = ("tid", "spans", "root_id", "_order")

    def __init__(self, tid: str):
        self.tid = tid
        self.spans: dict[int, Span] = {}
        self.root_id: int | None = None
        self._order: list[int] = []

    @property
    def closed(self) -> bool:
        root = self.spans.get(self.root_id)
        return root is not None and root.t_end is not None

    def span_list(self) -> list[Span]:
        return [self.spans[i] for i in self._order]

    def names(self) -> list[str]:
        """Span names in record order (test/assertion convenience)."""
        return [s.name for s in self.span_list()]

    def find(self, name: str) -> list[Span]:
        return [s for s in self.span_list() if s.name == name]

    def tree(self) -> dict:
        """Nested {name, t_start, t_end, attrs, children: [...]} from
        the root (None when the trace has no root yet)."""
        kids: dict[int | None, list[Span]] = {}
        for s in self.span_list():
            kids.setdefault(s.parent_id, []).append(s)

        def build(s: Span) -> dict:
            d = s.as_dict()
            d["children"] = [build(c) for c in kids.get(s.span_id, [])]
            return d

        root = self.spans.get(self.root_id)
        return build(root) if root is not None else None


class SpanTracer:
    """Bounded, thread-safe span recorder (see module docstring).

    All methods tolerate unknown trace ids by no-op'ing (a worker may
    publish a span for a request the router already finalized after a
    failover race — dropping it is correct: ownership of the result was
    already decided)."""

    def __init__(self, max_finished: int = DEFAULT_MAX_FINISHED):
        self._lock = threading.Lock()
        self._live: dict[str, Trace] = {}
        self._finished: deque[Trace] = deque(maxlen=max_finished)
        self._next_span = 0
        self.n_dropped = 0          # spans for unknown/finished traces

    # -- recording --------------------------------------------------------

    def begin(self, tid: str, name: str = "request", t: float = None,
              **attrs) -> str:
        """Open a trace with a root span; idempotent per tid."""
        t = time.monotonic() if t is None else t
        with self._lock:
            if tid in self._live:
                return tid
            tr = Trace(tid)
            sid = self._next_span
            self._next_span += 1
            tr.spans[sid] = Span(sid, None, name, t, None, attrs)
            tr.root_id = sid
            tr._order.append(sid)
            self._live[tid] = tr
        return tid

    def span(self, tid: str, name: str, parent: int = None,
             t_start: float = None, t_end: float = None,
             **attrs) -> int | None:
        """Record a span under `parent` (default: the root).  Pass
        `t_end` to record an already-finished span in one call; leave it
        None and `end_span` later for an open one.  Returns the span id
        (None when the trace is unknown — see class docstring)."""
        t_start = time.monotonic() if t_start is None else t_start
        with self._lock:
            tr = self._live.get(tid)
            if tr is None:
                self.n_dropped += 1
                return None
            sid = self._next_span
            self._next_span += 1
            parent = tr.root_id if parent is None else parent
            tr.spans[sid] = Span(sid, parent, name, t_start, t_end, attrs)
            tr._order.append(sid)
            return sid

    def event(self, tid: str, name: str, t: float = None,
              **attrs) -> int | None:
        """An instant (zero-duration) span — markers like `retire`,
        `failover`, `replay`."""
        t = time.monotonic() if t is None else t
        return self.span(tid, name, t_start=t, t_end=t, **attrs)

    def end_span(self, tid: str, span_id: int | None,
                 t_end: float = None, **attrs) -> None:
        if span_id is None:
            return
        t_end = time.monotonic() if t_end is None else t_end
        with self._lock:
            tr = self._live.get(tid)
            s = tr.spans.get(span_id) if tr is not None else None
            if s is None:
                self.n_dropped += 1
                return
            if s.t_end is None:
                s.t_end = t_end
            if attrs:
                s.attrs.update(attrs)

    def end(self, tid: str, t: float = None, **attrs) -> None:
        """Close the trace: end the root span (folding `attrs` — e.g.
        outcome=ok / outcome=exec_failed — into it) and park the trace
        on the bounded finished deque."""
        t = time.monotonic() if t is None else t
        with self._lock:
            tr = self._live.pop(tid, None)
            if tr is None:
                self.n_dropped += 1
                return
            root = tr.spans.get(tr.root_id)
            if root is not None:
                if root.t_end is None:
                    root.t_end = t
                root.attrs.update(attrs)
            self._finished.append(tr)

    # -- reading ----------------------------------------------------------

    def get(self, tid: str) -> Trace | None:
        """The live or (most recent) finished trace for `tid`."""
        with self._lock:
            tr = self._live.get(tid)
            if tr is not None:
                return tr
            for tr in reversed(self._finished):
                if tr.tid == tid:
                    return tr
        return None

    def finished(self) -> list[Trace]:
        with self._lock:
            return list(self._finished)

    def live(self) -> list[Trace]:
        with self._lock:
            return list(self._live.values())

    def stats(self) -> dict:
        with self._lock:
            return {"live": len(self._live),
                    "finished": len(self._finished),
                    "spans_recorded": self._next_span,
                    "dropped": self.n_dropped}
