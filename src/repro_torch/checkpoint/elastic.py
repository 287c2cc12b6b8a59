"""Elastic restart: resume a run on a different mesh than it was saved on
— the port of the reference's `checkpoint/elastic.py`.

Checkpoints store full (unsharded) logical arrays in the reference's
format (`store.py`), so resharding is placing the restored values by the
new mesh's parameter rules.  What this module adds is the policy:

  * pick the newest committed step;
  * rebuild placements for the *surviving* mesh;
  * validate divisibility (global batch % new data-parallel size), so the
    data pipeline's offset (global step x global batch) stays
    mesh-independent.

Every rank of the mesh calls both functions.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.distributed import sharding as SH
from repro_torch.models.params import flatten_tree
from repro_torch.train import optim as OPT
from repro_torch.train.step import place_train_state


def resume_or_init(root: str, init_fn, sc: SH.ShardingConfig,
                   global_batch: int) -> Tuple[Any, Any, int]:
    """Returns (params, opt_state, start_step), both trees as DTensors
    placed by the parameter rules on `sc.mesh`.  `init_fn()` gives the
    global initial parameters (the same on every rank, on the device they
    are to live on); they are used when no committed checkpoint exists,
    and as the structure and dtypes to restore into when one does.  The
    optimizer state is initialised fresh when `root/opt` does not hold
    the same step."""
    if global_batch % sc.n_data != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by the new mesh's "
            f"data-parallel size {sc.n_data}; choose a compatible mesh")

    step = store.latest_step(root)
    params = SH.as_tree(init_fn())
    if step is None:
        placed, _ = place_train_state(params, None, sc)
        return placed, OPT.init(placed), 0

    dev = next(flatten_tree(params))[1].device
    params = store.restore(root, step, params, device=dev)
    placed, _ = place_train_state(params, None, sc)
    if store.latest_step(root + "/opt") == step:
        opt = store.restore(root + "/opt", step, OPT.init(params),
                            device=dev)
        _, opt = place_train_state(params, opt, sc)
    else:
        opt = OPT.init(placed)
    return placed, opt, step


def save_state(root: str, step: int, params, opt_state,
               extra: Optional[dict] = None):
    """Save params to `root` and the optimizer state to `root/opt` as full
    arrays: every rank gathers its shards, rank 0 writes, and all wait
    for the commit."""
    params = SH.gather(params)
    opt_state = OPT.OptState(SH.full(opt_state.step), SH.gather(opt_state.m),
                             SH.gather(opt_state.v))
    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        store.save(root, step, params, extra)
        store.save(root + "/opt", step, opt_state, extra)
    if distributed:
        dist.barrier()
