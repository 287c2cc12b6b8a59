"""Functional layers on parameter dicts: the parts of the reference's
`nn.py` that the port's models and training use, and their
initialisers."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels.fused_mlp.ref import chain_operands, fused_mlp_ref
from repro_torch.models.params import ParamTree, flatten_tree, tree_map

LN_EPS = 1e-6  # the reference's layernorm eps (torch's default is 1e-5)


def uniform_init(gen: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Uniform in [-scale, scale) from `gen` on the generator's device (a
    CUDA generator draws on the card): drawn in float32, then cast to
    `dtype`, so a leaf's values do not depend on `dtype` beyond the cast."""
    return ((torch.rand(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * 2 - 1) * scale).to(dtype)


def normal_init(gen: torch.Generator, shape, std: float,
                dtype=torch.float32) -> torch.Tensor:
    """Normal(0, std**2) from `gen` on the generator's device, drawn in
    float32 and cast to `dtype`."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               use_bias: bool = True, dtype=torch.float32):
    """The reference's `dense_init`: w uniform +-1/sqrt(fan_in), zero b."""
    p = {"w": uniform_init(gen, (d_in, d_out), 1.0 / math.sqrt(max(1, d_in)),
                           dtype)}
    if use_bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=gen.device)
    return p


def mlp_chain_init(gen: torch.Generator, widths: Sequence[int],
                   use_bias: bool = True):
    """A chain of FC layers {"fc0": ..., "fc1": ...} (the paper's fusable
    dense blocks)."""
    return {f"fc{i}": dense_init(gen, widths[i], widths[i + 1], use_bias)
            for i in range(len(widths) - 1)}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b): a plain product outside any kernel, as in the
    reference, where XLA computes it.  A DTensor x (B, S, ...) whose
    sequence is sharded (the Megatron-SP boundary layout) is gathered
    along it first, as Megatron does before a column-parallel product:
    the product's (B * S) rows then shard as its batch does, where a
    batch and a sequence split together would make a strided sharding
    that DTensor plans redistributions for by a search over every mesh
    dim (slow on a three-axis mesh, refused by older releases).  The
    product's gradient is gathered along the sequence the same way (a
    residual branch hands it back sequence-sharded)."""
    from repro_torch.distributed import sharding as SH
    if x.dim() > 2 and SH.is_dtensor(x):
        y = SH.gathered_grad(SH.gather_dim(x, 1) @ p["w"], 1)
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_chain(p, x: torch.Tensor, final_act: bool = True) -> torch.Tensor:
    """The chain layer by layer with ReLU between (and after the last
    layer when `final_act`): the fused-MLP kernel's plain version on a
    parameter dict, the oracle of `kernels.fused_mlp.ops.fused_mlp_chain`."""
    return fused_mlp_ref(x, *chain_operands(p), final_act)


def layernorm(p, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with the reference's arithmetic: mean,
    mean squared deviation, rsqrt(var + eps), computed in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def layernorm_init(d: int, device=None, dtype=torch.float32):
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def rmsnorm_init(d: int, device=None, dtype=torch.float32):
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """RMSNorm over the last axis with the reference's arithmetic: mean of
    squares and rsqrt(ms + eps) in float32, `y * scale`, cast back."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * p["scale"]).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32):
    """The reference's `embedding_init`: normal * 0.02."""
    return {"emb": normal_init(gen, (vocab, d), 0.02, dtype)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table.  A vocab-sharded table (a DTensor) is looked up
    by DTensor's embedding rule: a masked local lookup and a partial sum
    over the vocab shards (the reference's `_pinned_embed_lookup`).  The
    ids keep their batch sharding; the table's FSDP dim is gathered first,
    as FSDP gathers a weight before its use (left to DTensor, the lookup
    of batch-sharded ids in it would replicate the ids and the rows)."""
    from repro_torch.distributed.sharding import gather_dim, is_dtensor, like
    if is_dtensor(p["emb"]):
        table = gather_dim(p["emb"], 1)
        return torch.nn.functional.embedding(like(ids, table), table)
    return p["emb"][ids]


def cast_floating(tree, dtype):
    """Cast the floating leaves of a nested dict/list/NamedTuple of tensors
    to `dtype` (a leaf already in `dtype` is returned as is)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def count_params(params) -> int:
    """Number of scalars in a parameter tree (a ParamTree or nested
    dicts / lists of tensors)."""
    if isinstance(params, ParamTree):
        params = params.tree()
    return sum(x.numel() for _, x in flatten_tree(params))


class _CotangentCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def cotangent_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Identity forward; casts the gradient to `dtype` in backward.  Put
    after the backbone's hidden states, it keeps the backbone's backward
    in the compute dtype although the loss's float32 ops make the incoming
    gradient float32; parameter gradients still land in float32 through
    the parameter cast."""
    return _CotangentCast.apply(x, dtype)
