"""The train step on one card — the port of the reference's
`train/step.py`: mixed precision, remat, gradient accumulation, chunked
cross-entropy.

    step = make_train_step(model, TrainConfig(), AdamWConfig())
    params, opt_state, metrics = step(params, opt_state, batch)

`params` is a ParamTree or its nested dict of float32 tensors; the step
returns the updated parameters as a nested dict (the inputs are not
modified) and metrics {"loss", "aux", "n_tokens", "grad_norm", "lr"} as
float32 scalar tensors, the reference's keys.  `batch` holds tokens,
labels and positions (B, S), as tensors on the parameters' device or as
numpy arrays (`data.synthetic.token_batch`), and optionally loss_mask.

On the card the step runs the hand-written kernels in both directions:
flash_attention's forward (its backward recomputes through the plain
version, as the reference's VJP does) and grouped_matmul's forward, dX and
dW (`kernels/grouped_matmul/ops.py`).

With a sharding config (`sc`, `distributed/sharding.py`) the step runs on
every rank of `sc.mesh`: the parameters and the optimizer state are
DTensors placed by `params_shardings` (`place_train_state`; plain global
tensors are placed on entry), the batch by `batch_specs`, the activations
by the shard callback, and the kernels run on local shards.  It returns
the parameters and state as DTensors in the same placements, and the
metrics as plain global values.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import nn
from repro_torch.distributed import sharding as SH
from repro_torch.models.params import ParamTree, flatten_tree, tree_map
from repro_torch.models.registry import Model
from repro_torch.train import losses as LO
from repro_torch.train import optim as OPT

METRIC_KEYS = ("loss", "aux", "n_tokens")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    accum_steps: int = 1
    use_chunked_ce: bool = True
    ce_chunks: int = 16
    aux_weight: float = 0.01       # MoE load-balance loss weight
    # cast gradients before the update (the reference's data-parallel
    # reduction dtype); AdamW still accumulates in float32
    grad_reduce_dtype: Any = None


def make_loss_fn(model: Model, tc: TrainConfig, shard=None, mesh=None):
    """loss_fn(params, batch) -> (total loss, {"loss", "aux",
    "n_tokens"}): the backbone in `tc.compute_dtype`, the head and the
    cross-entropy in float32 sums (chunked at vocab_size >= 8192)."""
    cfg = model.cfg
    shard = shard or SH.identity_shard

    def loss_fn(params, batch):
        cparams = nn.cast_floating(params, tc.compute_dtype)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if tc.use_chunked_ce and cfg.vocab_size >= 8192:
            hidden, aux = model.train_hidden(cparams, batch, shard=shard,
                                             mesh=mesh, remat=tc.remat)
            # keep the backbone's backward pass in the compute dtype
            hidden = nn.cotangent_cast(hidden, tc.compute_dtype)
            head_w, transpose, softcap = model.head_info(cparams)
            loss, n = LO.chunked_cross_entropy(
                hidden, head_w, labels, mask=mask, softcap=softcap,
                n_chunks=tc.ce_chunks, transpose_head=transpose)
        else:
            logits, aux = model.train_logits(cparams, batch, shard=shard,
                                             mesh=mesh, remat=tc.remat)
            logits = nn.cotangent_cast(logits, tc.compute_dtype)
            loss, n = LO.cross_entropy(logits, labels, mask=mask)
        total = loss + tc.aux_weight * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n}

    return loss_fn


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


def make_grad_fn(model: Model, tc: TrainConfig, sc=None):
    """grad_fn(params, batch) -> (gradient tree shaped as params, metrics
    {"loss", "aux", "n_tokens"}): one backward of `make_loss_fn` (no
    accumulation, no update).  `batch` holds tensors on the parameters'
    device.  Under `sc` the gradients are DTensors in their parameters'
    placements and the metrics plain global values."""
    loss_fn = make_loss_fn(
        model, tc, shard=SH.make_shard_fn(sc) if sc is not None else None,
        mesh=sc.mesh if sc is not None else None)

    def grads_of(params, batch):
        tree = params.tree() if isinstance(params, ParamTree) else params
        names, leaves = zip(*flatten_tree(tree))
        live = [p.detach().requires_grad_(p.is_floating_point())
                for p in leaves]
        by_name = dict(zip(names, live))
        view = _rebuild(tree, by_name)
        total, metrics = loss_fn(view, batch)
        wanted = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(SH.full(total), wanted,
                                       allow_unused=True))
        grads = {}
        for name, p in zip(names, live):
            g = next(got) if p.requires_grad else None
            if g is None:
                g = torch.zeros_like(p)
            elif SH.is_dtensor(p):
                g = g.redistribute(p.device_mesh, p.placements)
            grads[name] = g
        return _rebuild(tree, grads), {k: SH.full(v).detach()
                                       for k, v in metrics.items()}

    return grads_of


def make_train_step(model: Model, tc: TrainConfig,
                    opt_cfg: OPT.AdamWConfig, sc=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on the parameters' device (under `sc`, on every rank of its
    mesh)."""
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    grads_of = make_grad_fn(model, tc, sc)

    def train_step(params, opt_state: OPT.OptState, batch: dict):
        tree = params.tree() if isinstance(params, ParamTree) else params
        device = next(flatten_tree(tree))[1].device
        batch = _on_device(batch, device)
        if sc is not None:
            tree, opt_state = place_train_state(tree, opt_state, sc)
        a = tc.accum_steps

        def placed(b):
            return b if sc is None else \
                SH.distribute(b, SH.batch_specs(b, sc), sc.mesh)
        if a == 1:
            grads, metrics = grads_of(tree, placed(batch))
            if tc.grad_reduce_dtype is not None:
                grads = nn.cast_floating(grads, tc.grad_reduce_dtype)
        else:
            # micro-batched accumulation: summed float32 gradients and
            # metrics, then the reference's scaling
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), tree)
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=device) for k in METRIC_KEYS}
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                      [i] for k, v in batch.items()}
                g, m = grads_of(tree, placed(mb))
                grads = tree_map(torch.add, grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
            grads = tree_map(lambda g: g / a, grads)
            metrics = {k: v / a for k, v in metrics.items()}
            metrics["n_tokens"] = metrics["n_tokens"] * a
        params, opt_state, opt_metrics = OPT.apply_updates(
            tree, opt_state, grads, opt_cfg)
        metrics.update({k: SH.full(v) for k, v in opt_metrics.items()})
        return params, opt_state, metrics

    return train_step


def train_step_shardings(params, sc):
    """(param specs, OptState of specs): parameters and both moments
    follow the parameter rules, the step count is replicated."""
    p_specs = SH.params_shardings(params, sc)
    return p_specs, OPT.OptState(step=SH.replicated(sc), m=p_specs,
                                 v=p_specs)


def place_train_state(params, opt_state, sc):
    """Parameters and optimizer state as DTensors placed by
    `train_step_shardings` (leaves that are DTensors already are left as
    they are; plain leaves are the global values, the same on every
    rank)."""
    p_specs, o_specs = train_step_shardings(params, sc)

    def place(x, spec):
        return x if SH.is_dtensor(x) else \
            SH.constrain(x, spec, sc.mesh).detach()
    params = tree_map(place, SH.as_tree(params), p_specs)
    if opt_state is not None:
        opt_state = OPT.OptState(
            step=SH.full(opt_state.step), m=tree_map(place, opt_state.m,
                                                     o_specs.m),
            v=tree_map(place, opt_state.v, o_specs.v))
    return params, opt_state


def _rebuild(tree, by_name: dict, prefix: str = ""):
    """`tree`'s structure with each leaf replaced by by_name[dotted path]
    (the paths of `flatten_tree`)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_name, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, by_name, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return by_name[prefix[:-1]]
