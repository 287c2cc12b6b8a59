"""Checkpointing with atomic commit and async write — the port of the
reference's `checkpoint/store.py`, in its on-disk format, so a checkpoint
written by either package restores in the other.

Layout:
    <root>/step_<N>/           (N as %08d)
        manifest.json          # {"step", "extra", "leaves": {key: {"shape",
                               #   "dtype"}}}, dtype the logical one
        <flat-key>.npy         # one file per leaf
        COMMIT                 # written last -> marks the step complete

Keys are the tree path joined by "__": dict keys (sorted, as JAX flattens
a dict), NamedTuple field names (an `OptState`'s `step` / `m` / `v`) and
list indices.  A dtype numpy has no name for (bfloat16, float8) is stored
as its raw bits in unsigned words of its width, with the logical name in
the manifest.

Fault-tolerance contract:
  * a checkpoint is valid iff COMMIT exists (a step directory without it,
    or a leftover `.tmp`, is ignored and replaced by the next save);
  * `latest_step()` finds the newest valid step, so restart-after-crash is
    `restore(latest_step())`;
  * `save` copies one leaf at a time to the host and writes it, so a save
    never holds the whole tree twice in host memory;
  * `CheckpointManager` saves on a background thread; its `wait()` returns
    once every queued save has committed.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import ParamTree

_SEP = "__"

# torch dtypes numpy cannot name: stored as raw unsigned words of their width
_RAW = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
        torch.float8_e5m2: "float8_e5m2"}
_RAW_BY_NAME = {name: dt for dt, name in _RAW.items()}
_SIGNED = {1: torch.int8, 2: torch.int16}


class _Host:
    """A leaf copied to the host: the array np.save writes and the
    leaf's logical dtype name."""

    __slots__ = ("raw", "dtype")

    def __init__(self, raw: np.ndarray, dtype: str):
        self.raw, self.dtype = raw, dtype


def _tree(tree):
    return tree.tree() if isinstance(tree, ParamTree) else tree


def _items(node):
    """(key string, child) pairs of an inner node, in JAX's flatten order;
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """{key: leaf} over the tree's leaves (None is an empty subtree)."""
    out = {}
    items = _items(tree)
    if items is None:
        if tree is not None:
            out[prefix] = tree
        return out
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """`like`'s structure with each leaf replaced by leaves[key]."""
    def sub(k, v):
        return _unflatten(v, leaves, f"{prefix}{_SEP}{k}" if prefix else
                          str(k))
    if isinstance(like, dict):
        return {k: sub(k, v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(sub(f, v) for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(sub(i, v) for i, v in enumerate(like))
    return None if like is None else leaves[prefix]


def _gather_for_save(x, copy: bool = False) -> _Host:
    """One leaf on the host (`copy`: never sharing memory with `x`, as a
    CPU tensor otherwise would).  Multi-host port: write each process's
    addressable shards instead."""
    if isinstance(x, _Host):
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=copy)
        if t.dtype in _RAW:
            bits = t.view(_SIGNED[t.element_size()]).numpy()
            return _Host(bits.view(f"u{t.element_size()}"), _RAW[t.dtype])
        return _Host(t.numpy(), str(t.dtype).removeprefix("torch."))
    arr = np.array(x, copy=copy)
    return _Host(arr, str(arr.dtype))


def _from_host(arr: np.ndarray, logical: Optional[str]) -> torch.Tensor:
    if logical in _RAW_BY_NAME:
        dt = _RAW_BY_NAME[logical]
        return torch.from_numpy(arr.view(f"i{arr.itemsize}")).view(dt)
    return torch.from_numpy(arr)


def save(root: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Synchronous atomic save; returns the step directory."""
    step_dir = os.path.join(root, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(_tree(tree)).items():
        host = _gather_for_save(leaf)
        np.save(os.path.join(tmp_dir, key + ".npy"), host.raw)
        manifest["leaves"][key] = {"shape": list(host.raw.shape),
                                   "dtype": host.dtype}
        del host
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # atomic commit: rename then marker
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    with open(os.path.join(step_dir, "COMMIT"), "w") as f:
        f.write(str(time.time()))
    return step_dir


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(root, name, "COMMIT")):
            best = max(best or -1, int(m.group(1)))
    return best


def restore(root: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of `like` (a tree of tensors, or a
    ParamTree: then its nested dict), each leaf cast to the dtype of its
    `like` leaf and put on `device` (`resolve_device`: the card unless
    `device="cpu"`).  A leaf whose stored shape differs raises."""
    dev = resolve_device(device)
    step_dir = os.path.join(root, f"step_{step:08d}")
    if not os.path.exists(os.path.join(step_dir, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    like = _tree(like)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, leaf in _flatten(like).items():
        arr = np.load(os.path.join(step_dir, key + ".npy"))
        t = _from_host(arr, manifest["leaves"].get(key, {}).get("dtype"))
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
        leaves[key] = t.to(device=dev, dtype=leaf.dtype)
        del arr, t
    return _unflatten(like, leaves)


def read_manifest(root: str, step: int) -> dict:
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """Async, bounded-retention checkpoint writer.  `maybe_save` copies the
    tree to the host and queues it (a newer save replaces a pending one);
    `wait()` returns once every queued save has committed (and raises the
    first error a save hit); `close()` waits, then stops the writer."""

    def __init__(self, root: str, keep: int = 3, interval_steps: int = 100):
        self.root = root
        self.keep = keep
        self.interval = interval_steps
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint")
        self._worker.start()
        self._last_saved = -1

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree, extra = item
                save(self.root, step, tree, extra)
                self._gc()
            except Exception as e:      # noqa: BLE001 — raised by wait()
                self._error = self._error or e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.root)) if m)
        for s in steps[:-self.keep]:
            d = os.path.join(self.root, f"step_{s:08d}")
            if os.path.exists(os.path.join(d, "COMMIT")):
                shutil.rmtree(d, ignore_errors=True)

    def maybe_save(self, step: int, tree: Any, extra: Optional[dict] = None,
                   force: bool = False):
        if not force and (step % self.interval or step == self._last_saved):
            return False
        # snapshot to the host before queuing: the caller may update the
        # tensors in place after this returns
        host = {k: _gather_for_save(v, copy=True) for k, v in
                _flatten(_tree(tree)).items()}
        item = (step, _unflatten(_tree(tree), host), extra)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            try:
                self._q.get_nowait()     # drop the older pending save
                self._q.task_done()
            except queue.Empty:
                pass                     # the writer took it meanwhile
            self._q.put(item)
        self._last_saved = step
        return True

    def wait(self):
        """Block until every queued save has committed."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._worker.join()
