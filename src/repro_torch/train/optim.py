"""AdamW + global-norm clipping + the warmup-cosine schedule — the port of
the reference's `train/optim.py`, as functions over parameter trees
(nested dicts / lists of tensors).  Moments are float32 whatever the
parameters' dtype; the update is computed in float32 and cast back."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import ParamTree, flatten_tree, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any               # float32 tree shaped as the parameters
    v: Any


def _tree(params):
    return params.tree() if isinstance(params, ParamTree) else params


def init(params) -> OptState:
    params = _tree(params)
    first = next(flatten_tree(params))[1]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_ratio (float32)."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                        - cfg.warmup_steps)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(x.to(torch.float32).square().sum()
                          for _, x in flatten_tree(_tree(tree))))


def apply_updates(params, opt_state: OptState, grads, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, bias correction and
    decoupled weight decay.  Returns (new params as a nested tree,
    new OptState, {"grad_norm", "lr"})."""
    params = _tree(params)
    step = opt_state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g.square()
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) + \
            cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, opt_state.m, opt_state.v)
    new_p, new_m, new_v = _unzip3(out, params)
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                  "lr": lr}


def _unzip3(out, like):
    """Split a tree of 3-tuples (shaped as `like`) into three trees."""
    if isinstance(like, dict):
        parts = {k: _unzip3(out[k], like[k]) for k in like}
        return tuple({k: parts[k][i] for k in like} for i in range(3))
    if isinstance(like, (list, tuple)):
        parts = [_unzip3(o, lk) for o, lk in zip(out, like)]
        return tuple(type(like)(p[i] for p in parts) for i in range(3))
    return out
