"""Functional layers on parameter dicts: the parts of the reference's
`nn.py` that the MinkUNet path uses."""

from __future__ import annotations

import torch

LN_EPS = 1e-6  # the reference's layernorm eps (torch's default is 1e-5)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b): a plain product outside any kernel, as in the
    reference, where XLA computes it."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def layernorm(p, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with the reference's arithmetic: mean,
    mean squared deviation, rsqrt(var + eps), computed in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)
