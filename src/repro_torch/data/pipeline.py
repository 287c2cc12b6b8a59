"""Host-side data pipeline: deterministic skip-ahead + double-buffered
prefetch (the port of the reference's `data/pipeline.py`).

The iterator is a pure function of step number (`data/synthetic.py`), so
`start_step` restores any position instantly: no epoch bookkeeping to
checkpoint, and a restarted run regenerates exactly the batches it owes.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


class PrefetchIterator:
    """Wraps batch_fn(step) -> dict of arrays with a background producer
    thread and a bounded queue (double buffering: the host builds batch
    t+1 while the card runs step t).  Yields (step, batch).

    `device=None` keeps the batches as batch_fn made them (numpy arrays);
    given a device, the producer moves each array onto it as a tensor.  An
    exception in batch_fn is raised by the next `next()`.  `close()` stops
    the producer and joins its thread."""

    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 buffer: int = 2, device=None):
        self.batch_fn = batch_fn
        self.step = start_step
        self.buffer = buffer
        self.device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=buffer)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._produce, daemon=True,
                                   name="prefetch")
        self._t.start()

    def _produce(self):
        step = self.step
        while not self._stop.is_set():
            try:
                batch = self.batch_fn(step)
                if self.device is not None:
                    batch = {k: torch.as_tensor(np.asarray(v),
                                                device=self.device)
                             for k, v in batch.items()}
                item = (step, batch)
            except Exception as e:      # noqa: BLE001 — handed to next()
                item = (step, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(5.0)     # the producer checks the stop every 0.5 s
