"""Flight recorder: a bounded ring of recent structured serve events,
dumped automatically on the incidents worth a post-mortem.

Aggregate metrics say a request `exec_failed`; a span tree says where
*that request's* time went; neither says what the runtime was doing
*around* the failure — which dispatches were in flight, what the
watchdog flushed, which worker went quiet.  The flight recorder keeps
the last `capacity` structured events (submit / dispatch / retire /
failure / failover / shed, each a `(t, type, fields)` triple, appended
lock-cheap from inside the serving hot path) and snapshots the whole
ring **exactly once per incident** when one of the dump triggers fires:

  * a request completes `exec_failed` (retry/bisect budget exhausted),
  * a router failover (worker declared dead, work replayed),
  * a watchdog-fired `max_wait_s` deadline flush.

Dumps are keyed: the caller passes an incident key (rid, worker name,
flush ordinal) and a repeated key is a no-op — a failover that strands
ten requests produces ONE dump, not ten.  `max_dumps` bounds retained
snapshots (oldest dropped); an optional `sink` callable ships each dump
out as it happens (the JSONL exporter wires one in).  Like the tracer,
the recorder is optional: every seam is gated on `recorder is not None`
and the disabled path stays bit-identical.
"""

from __future__ import annotations

import threading
import time
from collections import deque

DEFAULT_CAPACITY = 512
DEFAULT_MAX_DUMPS = 16


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_dumps: int = DEFAULT_MAX_DUMPS, sink=None):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self.sink = sink
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._dumped_keys: set = set()
        self.dumps: deque = deque(maxlen=max(1, int(max_dumps)))
        self.n_events = 0
        self.n_dumps = 0
        self.n_suppressed = 0       # repeat-key triggers ignored

    def record(self, etype: str, t: float = None, **fields) -> None:
        """Append one structured event to the ring."""
        t = time.monotonic() if t is None else t
        with self._lock:
            self._ring.append((t, etype, fields))
            self.n_events += 1

    def dump(self, reason: str, key=None) -> dict | None:
        """Snapshot the ring for one incident; `key` dedupes — the same
        incident key dumps once, ever.  Returns the dump dict (also
        retained on `self.dumps` and shipped to `sink`), or None when
        the key was already dumped."""
        with self._lock:
            if key is not None:
                if key in self._dumped_keys:
                    self.n_suppressed += 1
                    return None
                self._dumped_keys.add(key)
            d = {"t": time.monotonic(), "reason": reason,
                 "key": repr(key) if key is not None else None,
                 "events": [{"t": t, "type": e, **f}
                            for t, e, f in self._ring]}
            self.dumps.append(d)
            self.n_dumps += 1
        if self.sink is not None:
            try:
                self.sink(d)
            except Exception:
                pass                # a broken sink must not kill serving
        return d

    def events(self) -> list:
        """Current ring contents (newest last) as plain dicts."""
        with self._lock:
            return [{"t": t, "type": e, **f} for t, e, f in self._ring]

    def stats(self) -> dict:
        with self._lock:
            return {"events": self.n_events, "ring": len(self._ring),
                    "capacity": self.capacity, "dumps": self.n_dumps,
                    "suppressed": self.n_suppressed}
