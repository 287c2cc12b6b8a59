"""Fault-tolerance runtime pieces of the training launcher and the
serving stack (the port of the reference's `launch/fault_tolerance.py`).

  * PreemptionHandler — SIGTERM/SIGINT -> finish the in-flight step, force a
    checkpoint, exit cleanly (what a cluster's maintenance event sends).
  * Ticker — joinable daemon ticker (the primitive under Heartbeat and the
    serve scheduler's background watchdog): on_tick() every interval_s,
    close() joins so threads never leak past their owner.
  * Pulse — lock-free liveness record: the worked thread beat()s, a
    watcher reads age()/stalled(stall_s).
  * Heartbeat — a stall watchdog over a Pulse.
  * StepTimer — rolling step-time stats; flags straggler steps
    (> k x median once 5 samples exist).  It times what lies between
    start() and stop(): on the card the caller reads the step's result (or
    synchronises) before stop(), so `step_s` is the step's device time,
    not the time to enqueue it.
"""

from __future__ import annotations

import collections
import signal
import statistics
import threading
import time
from typing import Callable, Optional


def _now() -> float:
    """The clock StepTimer reads (seconds, monotonic)."""
    return time.perf_counter()


class PreemptionHandler:
    """Install with `with PreemptionHandler() as p:` and poll
    `p.should_stop` once per step; the previous handlers come back on
    exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._orig = {}
        self.should_stop = False

    def _handle(self, signum, frame):
        self.should_stop = True

    def __enter__(self):
        for s in self._signals:
            self._orig[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, h in self._orig.items():
            signal.signal(s, h)
        return False


class Ticker:
    """Generic daemon ticker: invoke `on_tick()` every `interval_s`
    until `close()`.  `close()` joins the thread, so a closed ticker
    never outlives its owner — test runs and scheduler shutdown don't
    leak daemon threads.  Exceptions from a tick are reported and
    swallowed (a watchdog must not die of the condition it watches);
    use as a context manager for scoped lifetimes."""

    def __init__(self, interval_s: float, on_tick: Callable[[], None],
                 name: str = "ticker"):
        if interval_s <= 0:
            raise ValueError(f"Ticker interval must be > 0, got "
                             f"{interval_s}")
        self.interval_s = interval_s
        self.on_tick = on_tick
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name=name)
        self._t.start()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.on_tick()
            except Exception as e:      # noqa: BLE001 — keep ticking
                print(f"[{self._t.name}] tick failed: {e!r}", flush=True)

    @property
    def alive(self) -> bool:
        return self._t.is_alive()

    def close(self, timeout: float = 5.0):
        """Stop ticking and JOIN the thread (`_run` exits on the next
        event check, so this returns promptly even mid-interval)."""
        self._stop.set()
        self._t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Pulse:
    """Lock-free liveness record shared between one worked thread and a
    watcher: the worker `beat()`s whenever it makes progress, the watcher
    reads `age()` / `stalled(stall_s)`.  A bare monotonic float store —
    atomic under the GIL, no lock on the hot path — so beating from a
    serving loop costs one clock read."""

    def __init__(self):
        self._last = time.monotonic()

    def beat(self) -> None:
        self._last = time.monotonic()

    def age(self) -> float:
        """Seconds since the last beat."""
        return time.monotonic() - self._last

    def stalled(self, stall_s: float) -> bool:
        return self.age() > stall_s


class Heartbeat:
    """Background watchdog: if no beat() within `stall_s`, invoke
    on_stall (default: log loudly).  The cluster version reports to the
    coordinator instead.  `close()` joins the watcher thread."""

    def __init__(self, stall_s: float = 600.0,
                 on_stall: Optional[Callable] = None):
        self.stall_s = stall_s
        self.on_stall = on_stall or (lambda dt: print(
            f"[heartbeat] STALL: no step completed in {dt:.0f}s",
            flush=True))
        self._pulse = Pulse()
        self._ticker = Ticker(stall_s / 4, self._check, name="heartbeat")

    def beat(self):
        self._pulse.beat()

    def _check(self):
        dt = self._pulse.age()
        if dt > self.stall_s:
            self.on_stall(dt)

    def close(self):
        self._ticker.close()


class StepTimer:
    """Rolling step-time tracker with straggler flagging: a step is a
    straggler when at least 5 earlier steps are in the window and it took
    more than `straggler_factor` x their median."""

    def __init__(self, window: int = 50, straggler_factor: float = 2.0):
        self.times = collections.deque(maxlen=window)
        self.factor = straggler_factor
        self._t0 = None

    def start(self):
        self._t0 = _now()

    def stop(self) -> dict:
        dt = _now() - self._t0
        med = statistics.median(self.times) if self.times else dt
        straggler = len(self.times) >= 5 and dt > self.factor * med
        self.times.append(dt)
        return {"step_s": dt, "median_s": med, "straggler": straggler}
