"""Cross-pod gradient compression with error feedback — the port of the
reference's `distributed/compression.py`.

The multi-pod mesh's leading "pod" axis rides the slowest links, and in
plain DP they carry a full gradient all-reduce every step.  This module
replaces that exchange with:

    v   = g_pod_local + error            (error feedback, Seide et al.)
    q   = int8 per-block quantise(v)
    sum = all_gather(q) over 'pod' -> local dequant-sum
    error' = v - dequant(q)

Wire bytes per step drop 8x against a float32 all-reduce (int8 payload +
float32 per-block scales at 1/256 granularity).  Error feedback re-injects
the quantisation noise next step instead of losing it.

Each rank holds its own pod's error buffer (the reference stacks them on a
leading pod dim that shard_map splits).  `hierarchical_grads` computes a
pod's gradients on its half of the batch and exchanges only across pods;
in-pod reduction (DTensor over "data" / "model") is unchanged.  A sharded
gradient is quantised on its local shard.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map

BLOCK = 256


def _quantize_int8(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: returns (q int8 (blocks, BLOCK), scales
    float32 (blocks, 1))."""
    flat = v.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    peak = blocks.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA divides a tensor by a Python scalar through
    # its reciprocal, one ulp off the CPU's (and the reference's) quotient
    scale = peak / torch.full_like(peak, 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def compressed_psum(x: torch.Tensor, group,
                    error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over the ranks of `group` (the `pod` axis's
    process group).  Returns (mean, new_error)."""
    n = dist.get_world_size(group)
    v = x.to(torch.float32) + error
    q, scale = _quantize_int8(v)
    new_error = v - _dequantize(q, scale, x.shape, torch.float32)
    # wire: int8 payload + float32 scales (1/256 overhead)
    q_all = _all_gather(q, group)                   # (n, blocks, BLOCK)
    s_all = _all_gather(scale, group)
    total = torch.sum(q_all.to(torch.float32) * s_all, dim=0)
    flat = (total / n).reshape(-1)
    mean = flat[:x.numel()].reshape(x.shape).to(x.dtype)
    return mean, new_error.to(torch.float32)


def init_error_buffers(grads) -> Any:
    """This rank's error-feedback buffers: float32 zeros shaped as the
    (local) gradients."""
    return tree_map(lambda g: torch.zeros(
        _local(g).shape, dtype=torch.float32, device=g.device), grads)


def _local(g):
    from repro_torch.distributed.sharding import is_dtensor
    return g.to_local() if is_dtensor(g) else g


def hierarchical_grads(grad_fn, mesh, params, batch, errors):
    """Per-pod gradients + compressed cross-pod exchange.

    grad_fn(params, batch) -> (grads, metrics) computed over the pod-LOCAL
    part of the batch (this rank's pod's contiguous 1/n_pods of the
    leading dim).  Returns (mean grads, new error buffers, metrics
    averaged over pods).  Without a `pod` axis: the grads of the whole
    batch, the buffers unchanged.
    """
    from repro_torch.distributed.sharding import is_dtensor, mesh_axes
    if "pod" not in mesh_axes(mesh):
        grads, metrics = grad_fn(params, batch)
        return grads, errors, metrics

    group = mesh.get_group("pod")
    n_pods, pod = dist.get_world_size(group), dist.get_rank(group)

    def pod_part(x):
        per = x.shape[0] // n_pods
        return x[pod * per:(pod + 1) * per]
    grads, metrics = grad_fn(params, tree_map(pod_part, batch))

    def exchange(g, e):
        m, e2 = compressed_psum(_local(g), group, e)
        if is_dtensor(g):
            from torch.distributed.tensor import DTensor
            m = DTensor.from_local(m, g.device_mesh, g.placements,
                                   run_check=False)
        return m, e2
    pairs = tree_map(exchange, grads, errors)
    out_g = tree_map(lambda g, pr: pr[0], grads, pairs)
    out_e = tree_map(lambda g, pr: pr[1], grads, pairs)

    def pmean(m):
        m = m.clone()
        dist.all_reduce(m, group=group)
        return m / n_pods
    return out_g, out_e, {k: pmean(v) for k, v in metrics.items()}
