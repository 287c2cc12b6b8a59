"""Sparse convolution on point clouds: the computation flows.

Port flows and the reference flows they stand for:

    port flow      reference flow    realisation
    ---------      --------------    -----------
    "gms"          "gms"             gather all offsets, one einsum,
                                     scatter-add (torch ops)
    "fod"          "fod"             loop over offsets, gather + matmul +
                                     index_add per offset (torch ops)
    "cuda"         "pallas"          hand-written kernel
                                     `spconv_fod_cuda`; epilogue as torch
                                     post-ops
    "cuda_fused"   "pallas_fused"    hand-written kernel
                                     `spconv_fod_fused_cuda`; epilogue
                                     folded into the kernel's flush

`cuda_fused` always folds the epilogue.  The reference's planner may
decline to fuse (`core/fusion.py`), but only to fit a 64 MiB TPU VMEM
budget that the Hopper kernel does not have: its accumulator lives in
registers and its shared memory is one input chunk.

On CPU tensors the kernel flows run the kernels' plain PyTorch versions
(`kernels/spconv/ref.py`); on CUDA tensors they launch the kernels.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from repro_torch import nn
from repro_torch.core.mapping import (KernelMaps, PointCloud, SortedCloud,
                                      build_conv_maps)

FLOWS = ("gms", "fod", "cuda", "cuda_fused")


class Epilogue(NamedTuple):
    """Post-conv ops applied to the accumulator, in this fixed order:
    +bias -> layernorm -> +residual -> ReLU -> *mask.  Every field is
    optional (None / False = skip)."""

    bias: torch.Tensor | None = None        # (Cout,)
    ln_scale: torch.Tensor | None = None    # (Cout,)
    ln_bias: torch.Tensor | None = None     # (Cout,)
    relu: bool = False
    mask: torch.Tensor | None = None        # (M,) bool/float row validity
    residual: torch.Tensor | None = None    # (M, Cout)


def apply_epilogue(out: torch.Tensor, epi: Epilogue | None) -> torch.Tensor:
    """Plain realisation of `Epilogue`: the unfused path, and the oracle
    for the fused kernel's flush."""
    if epi is None:
        return out
    if (epi.ln_scale is None) != (epi.ln_bias is None):
        raise ValueError("Epilogue.ln_scale and ln_bias must come together")
    if epi.bias is not None:
        out = out + epi.bias[None, :]
    if epi.ln_scale is not None:
        out = nn.layernorm({"scale": epi.ln_scale, "bias": epi.ln_bias}, out)
    if epi.residual is not None:
        out = out + epi.residual
    if epi.relu:
        out = torch.relu(out)
    if epi.mask is not None:
        out = out * epi.mask.to(out.dtype)[:, None]
    return out


def gather_matmul_scatter(features: torch.Tensor, maps: KernelMaps,
                          weights: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Gather-MatMul-Scatter: (K, cap, Cin) gather, one batched product,
    scatter-add of the partial sums."""
    cout = weights.shape[-1]
    idx = maps.in_idx.clamp(min=0).long()
    gathered = features[idx] * maps.valid[..., None]
    psums = torch.einsum("kmc,kcd->kmd", gathered, weights)
    v = maps.valid.reshape(-1)
    out = torch.zeros((out_cap, cout), dtype=psums.dtype,
                      device=features.device)
    out.index_add_(0, maps.out_idx.reshape(-1)[v].long(),
                   psums.reshape(-1, cout)[v])
    return out.to(features.dtype)


def fetch_on_demand(features: torch.Tensor, maps: KernelMaps,
                    weights: torch.Tensor, out_cap: int) -> torch.Tensor:
    """PointAcc flow in torch ops: loop over offsets; each gathers its
    input rows, multiplies, and adds into the output accumulator (each
    output has at most one contribution per offset)."""
    cout = weights.shape[-1]
    out = torch.zeros((out_cap, cout), dtype=torch.float32,
                      device=features.device)
    for k in range(weights.shape[0]):
        v = maps.valid[k]
        rows = features[maps.in_idx[k].clamp(min=0).long()] * v[:, None]
        psum = rows @ weights[k]
        out.index_add_(0, maps.out_idx[k][v].long(), psum[v])
    return out.to(features.dtype)


def sparse_conv_apply(features: torch.Tensor, maps: KernelMaps,
                      weights: torch.Tensor, out_cap: int,
                      flow: str = "fod",
                      epilogue: Epilogue | None = None) -> torch.Tensor:
    """One sparse conv + optional epilogue through `flow` (see the module
    docstring for the flows)."""
    if flow == "gms":
        return apply_epilogue(
            gather_matmul_scatter(features, maps, weights, out_cap), epilogue)
    if flow == "fod":
        return apply_epilogue(
            fetch_on_demand(features, maps, weights, out_cap), epilogue)
    if flow == "cuda":
        from repro_torch.kernels.spconv import ops as spconv_ops
        return apply_epilogue(
            spconv_ops.sparse_conv_fod(features, maps, weights, out_cap),
            epilogue)
    if flow == "cuda_fused":
        from repro_torch.kernels.spconv import ops as spconv_ops
        return spconv_ops.sparse_conv_fused(features, maps, weights, out_cap,
                                            epilogue=epilogue)
    raise ValueError(f"unknown flow {flow!r}; one of {FLOWS}")


class SparseConvResult(NamedTuple):
    features: torch.Tensor
    pc: PointCloud
    maps: KernelMaps


def sparse_conv(pc: PointCloud, features: torch.Tensor,
                weights: torch.Tensor, kernel_size: int, stride: int = 1,
                flow: str = "fod", cap: int | None = None,
                engine: str | None = None,
                cache: SortedCloud | None = None) -> SparseConvResult:
    """Full sparse conv layer: mapping + conv in one call; invalid output
    rows are zeroed.  `cache` is an optional pre-sorted cloud of `pc`:
    layers that share a stride level pass the same SortedCloud so the
    ranking sort runs once per level."""
    maps, out_pc = build_conv_maps(pc, kernel_size, stride, cap=cap,
                                   engine=engine, cache=cache)
    out = sparse_conv_apply(features, maps, weights, out_pc.capacity, flow)
    out = out * out_pc.mask[:, None]
    return SparseConvResult(out, out_pc, maps)


def sparse_conv_transposed(features: torch.Tensor, maps: KernelMaps,
                           out_pc: PointCloud, weights: torch.Tensor,
                           flow: str = "fod",
                           epilogue: Epilogue | None = None) -> torch.Tensor:
    """Transposed (up-sampling) conv: reuse the forward maps with in/out
    roles swapped.  Maps without a transposed inverse table (v1, capped v2
    builds) work on every flow; the kernel flows then build the inverse by
    scatter, with a warning.  With an explicit epilogue the caller owns
    masking; without one invalid output rows are zeroed."""
    swapped = maps.swap()
    if flow in ("cuda", "cuda_fused") and swapped.inv is None:
        warnings.warn(
            "transposed conv on maps without an inverse table (built with "
            "engine='v1' or an explicit cap): the kernel flow falls back "
            "to a scatter-built inverse — rebuild the maps with "
            "engine='v2' for the scatter-free path", stacklevel=2)
    out = sparse_conv_apply(features, swapped, weights, out_pc.capacity,
                            flow, epilogue=epilogue)
    if epilogue is None:
        out = out * out_pc.mask[:, None]
    return out
