"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
recurrent form) and sLSTM (scalar memory, sequential scan) — the port of
the reference's `models/xlstm.py`.

mLSTM is a decayed linear attention with exponential gating and a max
stabiliser.  Both the stabiliser recurrence m_t = max(m_{t-1} + f_t, i_t)
(a max-plus scan) and the memory recurrence C_t = a_t C_{t-1} + b_t are
associative, so train / prefill runs over sequence chunks of `min(16, S)`
carrying (C, n, m), with log-step doubling scans inside a chunk where the
reference runs `lax.associative_scan` (float32 sums in another order).
With gradients on, each chunk runs under `torch.utils.checkpoint`, as the
reference `jax.checkpoint`s its chunk step.  The stabiliser starts at
-1e30, not at zero.

sLSTM is a sequential scan over time: a Python loop of S steps here (the
input projection for all steps is one product before the loop).

Decode is the O(1) recurrent step on (C, n, m) / sLSTM (c, n, h, m).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import costmode, nn
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import gathered_grad, identity_shard
from repro_torch.models.layers import split_heads
from repro_torch.models.mamba import check_chunks, chunked, linear_scan

M_INIT = -1e30      # the stabiliser's start


class MLSTMState(NamedTuple):
    c: torch.Tensor    # (B, H, dk, dv)
    n: torch.Tensor    # (B, H, dk)
    m: torch.Tensor    # (B, H)


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, D) float32
    n: torch.Tensor    # float32
    h: torch.Tensor    # the activation (or cache) dtype
    m: torch.Tensor    # float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def maxplus_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of m_t = max(m_{t-1} + a_t, b_t) along `dim`: returns
    (sum of a_1..a_t, m_t from m_0 = -inf), by doubling steps composing as
    the reference's `_maxplus_combine`."""
    n = b.shape[dim]
    d = 1
    while d < n:
        a_cur, a_prev = a.narrow(dim, d, n - d), a.narrow(dim, 0, n - d)
        b_cur, b_prev = b.narrow(dim, d, n - d), b.narrow(dim, 0, n - d)
        b = torch.cat([b.narrow(dim, 0, d),
                       torch.maximum(b_prev + a_cur, b_cur)], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_prev + a_cur], dim)
        d *= 2
    return a, b


def _mlstm_chunk(c, n, m, q, k, v, ii, fi):
    """One chunk, (B, chunk, H, ...) operands, float32."""
    fa, ib = maxplus_scan(fi, ii, 1)
    m_t = torch.maximum(m[:, None] + fa, ib)                 # (B, c, H)
    m_prev = torch.cat([m[:, None], m_t[:, :-1]], dim=1)
    f_eff = torch.exp(fi + m_prev - m_t)
    i_eff = torch.exp(ii - m_t)
    # memory recurrence (linear scan on matrices)
    kv = k[..., :, None] * v[..., None, :]                   # (B,c,H,dk,dv)
    acum, bcum = linear_scan(f_eff[..., None, None],
                             i_eff[..., None, None] * kv, 1)
    c_t = acum * c[:, None] + bcum
    acum3, bcum3 = linear_scan(f_eff[..., None], i_eff[..., None] * k, 1)
    n_t = acum3 * n[:, None] + bcum3                         # (B,c,H,dk)
    # readout
    num = torch.einsum("bchd,bchdv->bchv", q, c_t)
    den = torch.einsum("bchd,bchd->bch", q, n_t).abs()
    den = torch.maximum(den, torch.exp(-m_t))
    return c_t[:, -1], n_t[:, -1], m_t[:, -1], num / den[..., None]


def mlstm_cell(q, k, v, i_pre, f_pre, state: Optional[MLSTMState] = None,
               chunk: int = 16):
    """q/k (B,S,H,dk), v (B,S,H,dv), i/f pre-activations (B,S,H).

    Returns h (B,S,H,dv) and the final MLSTMState."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    i_pre = i_pre.to(torch.float32)
    f_pre = F.logsigmoid(f_pre.to(torch.float32))     # log f in (-inf, 0)
    if state is None:
        state = _mlstm_zero_state(b, h, dk, dv, q.device)
    chunk = check_chunks(s, chunk)
    pieces = ((x[:, i:i + chunk] for x in (qf, kf, vf, i_pre, f_pre))
              for i in range(0, s, chunk))
    (c, n, m), hs = chunked(_mlstm_chunk, tuple(state), pieces, s // chunk)
    return torch.cat(hs, 1).to(q.dtype), MLSTMState(c, n, m)


def mlstm_cell_decode(q, k, v, i_pre, f_pre, state: MLSTMState):
    """Single-step recurrence.  q/k (B,1,H,dk) etc."""
    dk = q.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    qf = q[:, 0].to(torch.float32) * scale
    kf = k[:, 0].to(torch.float32)
    vf = v[:, 0].to(torch.float32)
    ii = i_pre[:, 0].to(torch.float32)
    ff = F.logsigmoid(f_pre[:, 0].to(torch.float32))
    m_t = torch.maximum(state.m + ff, ii)
    f_eff = torch.exp(ff + state.m - m_t)[..., None, None]
    i_eff = torch.exp(ii - m_t)[..., None, None]
    c = f_eff * state.c + i_eff * (kf[..., :, None] * vf[..., None, :])
    n = f_eff[..., 0] * state.n + i_eff[..., 0] * kf
    num = torch.einsum("bhd,bhdv->bhv", qf, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_t))
    h_out = (num / den[..., None])[:, None]
    return h_out.to(q.dtype), MLSTMState(c, n, m_t)


def mlstm_block_init(gen: torch.Generator, cfg: ArchConfig,
                     dtype=torch.float32):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    hh = cfg.n_heads
    return {
        "up": nn.dense_init(gen, d, 2 * di, False, dtype),
        "wq": nn.dense_init(gen, di, di, False, dtype),
        "wk": nn.dense_init(gen, di, di, False, dtype),
        "wv": nn.dense_init(gen, di, di, False, dtype),
        "wif": nn.dense_init(gen, di, 2 * hh, True, dtype),
        "norm": nn.rmsnorm_init(di, gen.device, dtype),
        "down": nn.dense_init(gen, di, d, False, dtype),
    }


# the dims of the mLSTM cell's state leaves (c, n, m), for `Shard.local`
_MLSTM_STATE_DIMS = (("batch", None, None, None), ("batch", None, None),
                     ("batch", None))


def _mlstm_cell_apply(mode: str, q, k, v, i_pre, f_pre, *state):
    """The mLSTM cell of one mode: (h, *new state), h alone in training."""
    if mode == "decode":
        h, new = mlstm_cell_decode(q, k, v, i_pre, f_pre, MLSTMState(*state))
    else:
        h, new = mlstm_cell(q, k, v, i_pre, f_pre, state=None)
    return (h,) if mode == "train" else (h, *new)


def mlstm_block_apply(p, cfg: ArchConfig, x, *, mode: str,
                      state: Optional[MLSTMState] = None,
                      shard=identity_shard):
    """x (B, S, D).  Returns (out, new_state_or_None).  Under a sharding
    config the projections are DTensor products with their weights where
    `params_shardings` puts them; the cell, whose heads `state_specs`
    keeps whole, runs on each rank's batch rows with its heads whole
    (`Shard.local`)."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    hh = cfg.n_heads
    up = nn.dense(p["up"], x)
    xm, z = up[..., :di], up[..., di:]
    xm = shard(xm, ("batch", "seq", "d_inner"))
    q, k, v, gates = (split_heads(nn.dense(p[n], xm), hh)
                      for n in ("wq", "wk", "wv", "wif"))
    i_pre, f_pre = gates[..., 0], gates[..., 1]
    bsh, bshd = ("batch", "seq", None), ("batch", "seq", None, None)
    args, dims = (q, k, v, i_pre, f_pre), (bshd,) * 3 + (bsh,) * 2
    if mode == "decode":
        args, dims = args + tuple(state), dims + _MLSTM_STATE_DIMS
    h, *new = shard.local(
        functools.partial(_mlstm_cell_apply, mode), args, dims,
        (bshd,) + (_MLSTM_STATE_DIMS if mode != "train" else ()),
        {"batch": b})
    new_state = MLSTMState(*new) if new else None
    # the row-parallel product hands the gradient back split over "model";
    # the merge's backward splits it into heads
    h = gathered_grad(h.reshape(b, s, di), 2, hh)
    h = nn.rmsnorm(p["norm"], h)
    out = nn.dense(p["down"], h * F.silu(z))
    return shard(out, ("batch", "seq", "d_model")), new_state


def _mlstm_zero_state(batch, hh, dk, dv, device) -> MLSTMState:
    return MLSTMState(
        torch.zeros((batch, hh, dk, dv), dtype=torch.float32, device=device),
        torch.zeros((batch, hh, dk), dtype=torch.float32, device=device),
        torch.full((batch, hh), M_INIT, dtype=torch.float32, device=device))


def init_mlstm_state(cfg: ArchConfig, batch: int,
                     device=None) -> MLSTMState:
    di = cfg.ssm_expand * cfg.d_model
    hh = cfg.n_heads
    dk = di // hh
    return _mlstm_zero_state(batch, hh, dk, dk, device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block_init(gen: torch.Generator, cfg: ArchConfig,
                     dtype=torch.float32):
    d = cfg.d_model
    return {
        "wx": nn.dense_init(gen, d, 4 * d, True, dtype),    # z i f o
        "wr": nn.dense_init(gen, d, 4 * d, False, dtype),   # recurrent
        "norm": nn.rmsnorm_init(d, gen.device, dtype),
        "proj": nn.dense_init(gen, d, d, False, dtype),
    }


def _slstm_update(cfg: ArchConfig, wx_t, wr, st: SLSTMState, dtype):
    """One step from the input projection wx_t (B, 4D); the recurrent
    product runs in the promoted type of h and wr, as jnp promotes."""
    d = cfg.d_model
    ct = torch.promote_types(st.h.dtype, wr.dtype)
    pre = wx_t + st.h.to(ct) @ wr.to(ct)
    z = torch.tanh(pre[..., :d])
    i_pre = pre[..., d:2 * d].to(torch.float32)
    f_pre = F.logsigmoid(pre[..., 2 * d:3 * d].to(torch.float32))
    o = torch.sigmoid(pre[..., 3 * d:])
    m_t = torch.maximum(f_pre + st.m, i_pre)
    i_eff = torch.exp(i_pre - m_t)
    f_eff = torch.exp(f_pre + st.m - m_t)
    c = f_eff * st.c + i_eff * z.to(torch.float32)
    n = f_eff * st.n + i_eff
    h = o * (c / torch.clamp(n, min=1e-6)).to(dtype)
    return SLSTMState(c, n, h, m_t)


def _slstm_scan(cfg: ArchConfig, dtype, wx, wr, *state):
    """The sLSTM's time loop over the input projection wx (B, S, 4D) from
    a state (zeros where none is given): (h (B, S, D), *final state)."""
    b, s = wx.shape[:2]
    st = SLSTMState(*state) if state else init_slstm_state(
        cfg, b, dtype, wx.device)

    def trip(st, xs):
        st = _slstm_update(cfg, xs[0], wr, SLSTMState(*st), dtype)
        return tuple(st), st.h

    steps = ((wx[:, t],) for t in range(s))
    if costmode.enabled() and s > 3:
        # the dry run's counting: three steps counted as all s
        st, hs = costmode.loop(trip, tuple(st), steps, s)
    else:
        hs = []
        for xs in steps:
            st, h = trip(st, xs)
            hs.append(h)
    return (torch.stack(hs, dim=1), *st)


def slstm_block_apply(p, cfg: ArchConfig, x, *, mode: str,
                      state: Optional[SLSTMState] = None,
                      shard=identity_shard):
    """x (B, S, D).  Returns (out, new_state_or_None).  Under a sharding
    config the projections are DTensor products with their weights where
    `params_shardings` puts them; the time loop, whose every step needs
    the whole of h for its recurrent product, runs on each rank's batch
    rows with the recurrent weight whole (`Shard.local`), as `state_specs`
    keeps the state whole over "model"."""
    b, s, d = x.shape
    if mode == "decode" and (state is None or s != 1):
        raise ValueError("sLSTM decode takes one position and a state")
    wx = nn.dense(p["wx"], x)
    st = tuple(state) if state is not None else ()
    h, *new = shard.local(
        functools.partial(_slstm_scan, cfg, x.dtype), (wx, p["wr"]["w"], *st),
        (("batch", "seq", None), (None, None)) + (("batch", None),) * len(st),
        (("batch", "seq", None),) + (("batch", None),) * 4, {"batch": b})
    new_state = SLSTMState(*new) if mode != "train" else None
    out = nn.dense(p["proj"], nn.rmsnorm(p["norm"], h))
    return shard(out, ("batch", "seq", "d_model")), new_state


def init_slstm_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> SLSTMState:
    d = cfg.d_model
    return SLSTMState(
        torch.zeros((batch, d), dtype=torch.float32, device=device),
        torch.zeros((batch, d), dtype=torch.float32, device=device),
        torch.zeros((batch, d), dtype=dtype, device=device),
        torch.full((batch, d), M_INIT, dtype=torch.float32, device=device))
