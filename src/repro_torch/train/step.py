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
dW (`kernels/grouped_matmul/ops.py`).  A sharding config (`sc`) is not
ported: ROADMAP Queue A item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import nn
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


def make_loss_fn(model: Model, tc: TrainConfig):
    """loss_fn(params, batch) -> (total loss, {"loss", "aux",
    "n_tokens"}): the backbone in `tc.compute_dtype`, the head and the
    cross-entropy in float32 sums (chunked at vocab_size >= 8192)."""
    cfg = model.cfg

    def loss_fn(params, batch):
        cparams = nn.cast_floating(params, tc.compute_dtype)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if tc.use_chunked_ce and cfg.vocab_size >= 8192:
            hidden, aux = model.train_hidden(cparams, batch, remat=tc.remat)
            # keep the backbone's backward pass in the compute dtype
            hidden = nn.cotangent_cast(hidden, tc.compute_dtype)
            head_w, transpose, softcap = model.head_info(cparams)
            loss, n = LO.chunked_cross_entropy(
                hidden, head_w, labels, mask=mask, softcap=softcap,
                n_chunks=tc.ce_chunks, transpose_head=transpose)
        else:
            logits, aux = model.train_logits(cparams, batch, remat=tc.remat)
            logits = nn.cotangent_cast(logits, tc.compute_dtype)
            loss, n = LO.cross_entropy(logits, labels, mask=mask)
        total = loss + tc.aux_weight * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n}

    return loss_fn


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


def make_grad_fn(model: Model, tc: TrainConfig):
    """grad_fn(params, batch) -> (gradient tree shaped as params, metrics
    {"loss", "aux", "n_tokens"}): one backward of `make_loss_fn` (no
    accumulation, no update).  `batch` holds tensors on the parameters'
    device."""
    loss_fn = make_loss_fn(model, tc)

    def grads_of(params, batch):
        tree = params.tree() if isinstance(params, ParamTree) else params
        names, leaves = zip(*flatten_tree(tree))
        live = [p.detach().requires_grad_(p.is_floating_point())
                for p in leaves]
        by_name = dict(zip(names, live))
        view = _rebuild(tree, by_name)
        total, metrics = loss_fn(view, batch)
        wanted = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(total, wanted, allow_unused=True))
        grads = {}
        for name, p in zip(names, live):
            g = next(got) if p.requires_grad else None
            grads[name] = torch.zeros_like(p) if g is None else g
        return _rebuild(tree, grads), {k: v.detach()
                                       for k, v in metrics.items()}

    return grads_of


def make_train_step(model: Model, tc: TrainConfig,
                    opt_cfg: OPT.AdamWConfig, sc=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on the parameters' device."""
    if sc is not None:
        raise NotImplementedError(
            "sharded training (a ShardingConfig) is not ported yet: ROADMAP "
            "Queue A item 6; the port trains on one card (sc=None)")
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    grads_of = make_grad_fn(model, tc)

    def train_step(params, opt_state: OPT.OptState, batch: dict):
        tree = params.tree() if isinstance(params, ParamTree) else params
        device = next(flatten_tree(tree))[1].device
        batch = _on_device(batch, device)
        a = tc.accum_steps
        if a == 1:
            grads, metrics = grads_of(tree, batch)
            if tc.grad_reduce_dtype is not None:
                grads = nn.cast_floating(grads, tc.grad_reduce_dtype)
        else:
            # micro-batched accumulation: summed float32 gradients and
            # metrics, then the reference's scaling
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), tree)
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=device) for k in METRIC_KEYS}
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                      [i] for k, v in batch.items()}
                g, m = grads_of(tree, mb)
                grads = tree_map(torch.add, grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
            grads = tree_map(lambda g: g / a, grads)
            metrics = {k: v / a for k, v in metrics.items()}
            metrics["n_tokens"] = metrics["n_tokens"] * a
        params, opt_state, opt_metrics = OPT.apply_updates(
            tree, opt_state, grads, opt_cfg)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


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
