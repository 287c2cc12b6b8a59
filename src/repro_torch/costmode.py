"""Cost-accounting mode for the dry run's counted runs — the port of the
reference's `costmode.py`.

In the reference, XLA's `cost_analysis()` visits a `while` body once,
whatever its trip count, so under cost mode the layer scan and the
chunked-CE scan unroll into straight-line code and the depth-2 minus
depth-1 delta is one body's true cost.

No layer loop of the port needs it: the port counts the ops a step
dispatches, and the layer loop (`models/lm.py` `lm_apply`) and the
chunked cross-entropy (`train/losses.py`) are Python loops that dispatch
every trip.  So are the recurrent mixers' time loops — mamba's chunk scan
(`models/mamba.chunked`, 128 positions a chunk), the mLSTM's (16) and the
sLSTM's step loop (`models/xlstm.py`, one position a step) — which the
reference's HLO counts once.  Their trips have identical shapes, and a
32768-position prefill dispatches some 10^6 fake ops a layer through
them, so under cost mode a loop of more than three trips runs three,
the second counted for all but the first and the last (`loop`,
`weight`): the counts are the full loop's, its backward's as well
(`tests/test_torch_dryrun.py` holds them equal), with no trip's shape
guessed.  The dry
run enters cost mode around every run it counts: the depth-1 and depth-2
runs, as the reference does, and the full-depth run too.
"""

import contextlib

import torch

# Process-wide, where the reference keeps a context variable: autograd runs
# a CUDA tensor's backward (a checkpointed body's recompute included) on a
# thread of its own, which sees no context variable the caller set, and
# the caller waits for it.
_STATE = {"enabled": 0, "weight": 1}


def enabled() -> bool:
    return _STATE["enabled"] > 0


@contextlib.contextmanager
def enable():
    _STATE["enabled"] += 1
    try:
        yield
    finally:
        _STATE["enabled"] -= 1


def weight() -> int:
    """How many times an op dispatched now counts: the product of the
    `weighted` contexts around it and, in a backward, the weight of the
    autograd node that runs it (`loop` tags a trip's nodes)."""
    w = _STATE["weight"]
    if _STATE["enabled"]:
        from repro_torch import compat
        node = compat._current_autograd_node()
        if node is not None:
            w *= node.metadata.get(_TAG, 1)
    return w


@contextlib.contextmanager
def weighted(n: int):
    """Ops dispatched inside count n times as often (nested weights
    multiply)."""
    saved = _STATE["weight"]
    _STATE["weight"] = saved * n
    try:
        yield
    finally:
        _STATE["weight"] = saved


_TAG = "costmode_weight"


def _sequence_nr() -> int:
    """The sequence number the next autograd node made on this thread
    takes (uncounted: weight 0)."""
    with weighted(0), torch.enable_grad():
        probe = torch.zeros((), requires_grad=True) * 1
        return probe.grad_fn._sequence_nr() + 1


def _tag(outputs, since: int, w: int) -> None:
    """Weight w on every autograd node behind `outputs` made at or after
    sequence number `since` (a leaf's AccumulateGrad excepted): the ops
    their backward runs, a checkpointed recompute and the gradients they
    add into a buffer included, count w times."""
    stack = [t.grad_fn for t in outputs
             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad" or \
                node._sequence_nr() < since:
            continue
        node.metadata[_TAG] = w
        stack.extend(n for n, _ in node.next_functions)


def loop(trip, carry: tuple, pieces, n: int):
    """A loop of n trips of identical shapes, `carry, y = trip(carry,
    piece)` over `pieces` (a generator, so that its slicing counts in its
    trip's weight), run as three: the first, the second standing for
    trips 2 to n - 1, and the last.  The second trip's forward ops count
    n - 2 times, and so do its autograd nodes' in the backward (`_tag`).
    Three trips, not one, because the first takes no carry gradient and
    the gradients of n trips add n - 1 times into each input they share:
    the backward then counts, with the second's gradients added once at
    weight n - 2 and the first's once, what the full loop's does.  Returns
    (the last carry, n ys: the three trips' and n - 3 detached views of
    the second's, so that a concatenation reads n inputs and hands back
    no gradient to them)."""
    it = iter(pieces)
    ys = []
    for w in (1, n - 2, 1):
        tag = w != 1 and torch.is_grad_enabled()
        since = _sequence_nr() if tag else 0
        with weighted(w):
            carry, y = trip(carry, next(it))
        if tag:
            _tag(tuple(carry) + (y,), since, w)
        ys.append(y)
    return carry, ys[:2] + [ys[1].detach() for _ in range(n - 3)] + ys[2:]
