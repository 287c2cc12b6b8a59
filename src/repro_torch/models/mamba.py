"""Mamba (S6) selective-scan block of the jamba hybrid — the port of the
reference's `models/mamba.py`.

Train / prefill: a scan over chunks of `min(128, S)` positions that carries
the (B, d_inner, d_state) float32 state from chunk to chunk.  Inside a
chunk the recurrence h_t = da_t * h_{t-1} + u_t runs as a log-step doubling
scan over the chunk axis (`linear_scan`), where the reference runs
`lax.associative_scan`: the same compositions, with float32 products and
sums in another order.  The scan inputs `da` and `u` (B, chunk, d_inner,
d_state) are built chunk by chunk, never for the whole sequence.  With
gradients on, each chunk runs under `torch.utils.checkpoint`, as the
reference `jax.checkpoint`s its chunk step, so the backward recomputes the
chunk's internals instead of keeping them.

Decode: the O(1) recurrent step on (conv_state, ssm_state).

The reference computes all of this in plain jnp (no Pallas kernel), so
plain torch is its port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import costmode, nn
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import identity_shard, reduced


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv - 1, d_inner)
    ssm: torch.Tensor     # (B, d_inner, d_state), float32


def _dt_rank(cfg: ArchConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.d_state
    dt_rank = _dt_rank(cfg)
    dev = gen.device
    return {
        "in_proj": nn.dense_init(gen, d, 2 * di, False, dtype),
        "conv_w": nn.normal_init(gen, (cfg.d_conv, di), 0.1, dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": nn.dense_init(gen, di, dt_rank + 2 * n, False, dtype),
        "dt_proj": nn.dense_init(gen, dt_rank, di, True, dtype),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1).to(dtype),
        "D": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": nn.dense_init(gen, di, d, False, dtype),
    }


def _split_xproj(cfg: ArchConfig, dbc: torch.Tensor):
    n = cfg.d_state
    dt_rank = _dt_rank(cfg)
    return (dbc[..., :dt_rank], dbc[..., dt_rank:dt_rank + n],
            dbc[..., dt_rank + n:])


def _ssm_params(p, cfg: ArchConfig, x: torch.Tensor):
    """x (B, S, di) post-conv -> dt (B, S, di) float32, A (di, N) float32,
    B and C (B, S, N) in x's dtype."""
    # under a sharding config the product sums over the d_inner shards:
    # reduced here, once, on its narrow output
    dt_r, bm, c = _split_xproj(cfg, reduced(nn.dense(p["x_proj"], x)))
    dt = F.softplus(nn.dense(p["dt_proj"], dt_r)).to(torch.float32)
    a = -torch.exp(p["A_log"].to(torch.float32))
    return dt, a, bm, c


def _discretize(dt, a, x, bm):
    """da (B, S, di, N) decay and u (B, S, di, N) injection, float32."""
    da = torch.exp(dt[..., None] * a)
    u = (dt * x.to(torch.float32))[..., None] \
        * bm.to(torch.float32)[:, :, None, :]
    return da, u


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of x_t = a_t * x_{t-1} + b_t along `dim` (a may
    broadcast against b in the other dims): returns (prod of a_1..a_t,
    x_t from x_0 = 0), by log2(n) doubling steps, each composing every
    position with the one `d` before it as the reference's
    `_scan_combine` does."""
    n = b.shape[dim]
    d = 1
    while d < n:
        a_cur, a_prev = a.narrow(dim, d, n - d), a.narrow(dim, 0, n - d)
        b_cur, b_prev = b.narrow(dim, d, n - d), b.narrow(dim, 0, n - d)
        b = torch.cat([b.narrow(dim, 0, d), a_cur * b_prev + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_cur * a_prev], dim)
        d *= 2
    return a, b


def chunked(step, carry: tuple, chunks, n_chunks: int = 0):
    """Run `step(*carry, *chunk) -> (*carry, y)` over the chunks in order,
    each under `torch.utils.checkpoint` when it may need a gradient; returns
    (final carry, the ys).  Under `costmode` (the dry run's counting) a
    loop of more than three of its `n_chunks` chunks runs three of them,
    counted as all (`costmode.loop`)."""
    def trip(carry, xs):
        args = carry + tuple(xs)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in args if isinstance(t, torch.Tensor)):
            out = checkpoint(step, *args, use_reentrant=False)
        else:
            out = step(*args)
        return tuple(out[:-1]), out[-1]

    if costmode.enabled() and n_chunks > 3:
        return costmode.loop(trip, carry, chunks, n_chunks)
    ys = []
    for xs in chunks:
        carry, y = trip(carry, xs)
        ys.append(y)
    return carry, ys


def check_chunks(s: int, chunk: int) -> int:
    """The scan's chunk, min(chunk, s); raises where the reference asserts:
    when s is no multiple of it."""
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the scan "
                         f"chunk {chunk}")
    return chunk


def _scan_chunk(h, dt, a, x, bm, c):
    da, u = _discretize(dt, a, x, bm)                       # (B, c, di, N)
    acum, ucum = linear_scan(da, u, 1)
    h_t = acum * h[:, None] + ucum
    y = torch.einsum("bcdn,bcn->bcd", h_t, c.to(torch.float32))
    return h_t[:, -1], y


def selective_scan(p, cfg: ArchConfig, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """x (B, S, di) -> (y (B, S, di), h_final (B, di, N) float32)."""
    dt, a, bm, c = _ssm_params(p, cfg, x)
    return scan(dt, a, x, bm, c, h0, chunk)


def scan(dt, a, x, bm, c, h0: Optional[torch.Tensor] = None,
         chunk: int = 128):
    """The selective scan from its inputs (`_ssm_params`): each d_inner
    channel on its own.  x (B, S, di) -> (y (B, S, di) in x's dtype,
    h_final (B, di, N) float32)."""
    b, s, di = x.shape
    chunk = check_chunks(s, chunk)
    h = h0 if h0 is not None else torch.zeros(
        (b, di, a.shape[-1]), dtype=torch.float32, device=x.device)
    pieces = ((dt[:, i:i + chunk], a, x[:, i:i + chunk], bm[:, i:i + chunk],
               c[:, i:i + chunk]) for i in range(0, s, chunk))
    (h,), ys = chunked(_scan_chunk, (h,), pieces, s // chunk)
    return torch.cat(ys, 1).to(x.dtype), h


def _scan_step(dt, a, x, bm, c, h):
    """One decode position of the scan: x (B, 1, di), h (B, di, N) ->
    (y (B, 1, di) float32, new h)."""
    da, u = _discretize(dt, a, x, bm)
    h = da[:, 0] * h + u[:, 0]                               # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, c[:, 0].to(torch.float32))[:, None]
    return y, h


def _causal_conv(x: torch.Tensor, w, bias,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, k = d_conv, then SiLU: x (B, S, di), w
    (k, di), each channel on its own.  Returns (out, the new conv state:
    the last k - 1 inputs)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, S+k-1, di)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(out + bias), xp[:, -(k - 1):]


# the dims of the per-channel parts' tensors, for `Shard.local`
_BSI = ("batch", "seq", "d_inner")
_STATE_DIMS = (("batch", None, "d_inner"), ("batch", "d_inner", None))


def mamba_apply(p, cfg: ArchConfig, x: torch.Tensor, *, mode: str,
                state: Optional[MambaState] = None, shard=identity_shard):
    """x (B, S, D).  Returns (out, new_state_or_None).  Under a sharding
    config the conv and the scan, which act on each d_inner channel
    alone, run on each rank's channels (d_inner over "model", with the
    weights and states where `params_shardings` and `state_specs` put
    them) and the batch's rows, with whole sequences (`Shard.local`); the
    products around them are DTensor products, the x_proj one reduced
    over "model"."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    decode = mode == "decode"
    if decode and (state is None or s != 1):
        raise ValueError("mamba decode takes one position and a state")
    sizes = {"batch": b, "d_inner": di}

    xz = nn.dense(p["in_proj"], x)
    xin, z = xz[..., :di], xz[..., di:]
    xin = shard(xin, _BSI)

    conv_args = (xin, p["conv_w"], p["conv_b"])
    conv_dims = (_BSI, (None, "d_inner"), ("d_inner",))
    if decode:
        conv_args, conv_dims = conv_args + (state.conv,), \
            conv_dims + _STATE_DIMS[:1]
    xc, conv_state = shard.local(_causal_conv, conv_args, conv_dims,
                                 (_BSI,) + _STATE_DIMS[:1], sizes)

    dt, a, bm, c = _ssm_params(p, cfg, xc)
    bsn = ("batch", "seq", None)
    scan_args = (dt, a, xc, bm, c)
    scan_dims = (_BSI, ("d_inner", None), _BSI, bsn, bsn)
    if decode:
        y, h = shard.local(_scan_step, scan_args + (state.ssm,),
                           scan_dims + _STATE_DIMS[1:],
                           (_BSI,) + _STATE_DIMS[1:], sizes)
        new_state = MambaState(conv_state, h)
    else:
        y, h = shard.local(scan, scan_args, scan_dims,
                           (_BSI,) + _STATE_DIMS[1:], sizes)
        new_state = MambaState(conv_state, h) if mode == "prefill" else None

    y = y.to(x.dtype) + p["D"] * xc
    out = nn.dense(p["out_proj"], y * F.silu(z))
    return shard(out, ("batch", "seq", "d_model")), new_state


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaState:
    di = cfg.ssm_expand * cfg.d_model
    return MambaState(
        conv=torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                        device=device))
