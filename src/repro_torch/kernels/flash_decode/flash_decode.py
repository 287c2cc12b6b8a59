"""Wrapper of the flash-decode kernel (`csrc/flash_decode.cu`).

  * `flash_decode_cuda` — q (B, Hq, hd) against a cache k/v (B, S, Hkv, hd)
    masked by per-sequence `lengths` (B,) -> (B, Hq, hd); replaces the
    reference's `flash_decode_pallas`.

A CPU tensor goes to the plain version (`ref.flash_decode_ref`) and the
launch count does not move.  A CUDA tensor launches the kernel on the
current stream, or raises.  The launch is planned from shapes, dtypes, data
pointers and the SM count (`plan_launch`), never from the values in
`lengths`: the kernel reads those on the device, splits each sequence's
valid prefix over `n_split` CTAs of one cluster and reads no slot at or past
`lengths[b]`, so the cache is not padded and the call can be replayed in a
CUDA graph with new lengths.  `LAUNCHES` counts kernel launches: one a call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

DTYPES = (torch.float32, torch.bfloat16)
SMEM_BYTES = 232448
THREADS = 128                # a CTA: 4 warps
MAX_SPLIT = 8                # CTAs a kv head: the portable cluster size
SPLIT_POSITIONS = 64         # a split for at most every 64 cache slots
WIDTHS = (16, 8, 4, 2)       # bytes a K/V load, widest first
LOADS = (1, 2, 4)            # loads a lane covers of one row
HEADS = (1, 2, 4)            # query heads a CTA

LAUNCHES = {"flash_decode": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Plan(NamedTuple):
    vec: int                 # bytes a K/V load
    nv: int                  # loads a lane covers of one cached row
    gs: int                  # lanes of a row (a power of two <= 32)
    gt: int                  # query heads a CTA
    n_split: int             # CTAs (one cluster) a kv head's head group
    grid: tuple[int, int]    # (B * Hkv * ceil(G / gt), n_split)
    smem: int                # dynamic shared memory a CTA, bytes

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def cluster(self) -> bool:
        return self.n_split > 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn():
    fn = build.load("flash_decode").flash_decode
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                       _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_splits(bh: int, s: int, n_sm: int) -> int:
    """CTAs a (batch, kv head): the smallest power of two <= MAX_SPLIT that
    gives at least 2 x n_sm CTAs over `bh` of them, capped at
    ceil(s / SPLIT_POSITIONS) (a power of two, at least 1).  From shapes
    and the SM count only."""
    cap = max(1, min(MAX_SPLIT, -(-s // SPLIT_POSITIONS)))
    n = 1
    while 2 * n <= cap and bh * n < 2 * n_sm:
        n *= 2
    return n


def smem_bytes(gs: int, gt: int, hd: int, n_split: int) -> int:
    """Shared memory of one CTA: the partial (acc, m, l) of each of its
    THREADS / gs lane groups and, for a cluster, one slot for each CTA's
    (used on rank 0), in float32."""
    slots = THREADS // gs + (n_split if n_split > 1 else 0)
    return 4 * slots * gt * (hd + 2)


def plan_launch(q, k, v, n_sm: int, n_split: int | None = None) -> Plan:
    """The kernel's launch for these operands: the widest load that divides
    the row and both caches' alignment, the loads and lanes a row takes,
    the heads a CTA holds and the split (`plan_splits` unless given).
    Cached on the shapes, the cache's element size, both caches' data
    pointers mod 16, the SM count and `n_split`."""
    return _plan(tuple(q.shape), k.shape[1], k.shape[2], k.element_size(),
                 k.data_ptr() % WIDTHS[0], v.data_ptr() % WIDTHS[0], n_sm,
                 n_split)


@functools.lru_cache(maxsize=256)
def _plan(q_shape, s, hkv, es, k_align, v_align, n_sm, n_split) -> Plan:
    b, hq, hd = q_shape
    row = hd * es
    vec = next(w for w in WIDTHS if w >= es and row % w == 0
               and k_align % w == 0 and v_align % w == 0)
    per_row = row // vec
    nv = next((n for n in LOADS if per_row <= 32 * n), None)
    if nv is None:
        raise ValueError(f"head_dim {hd} at {es} bytes an element takes "
                         f"{per_row} loads of {vec} bytes a row; the kernel "
                         f"holds at most {32 * LOADS[-1]}")
    gs = 1 << (-(-per_row // nv) - 1).bit_length()
    g = hq // hkv
    gt = next((t for t in HEADS if t >= g), HEADS[-1])
    grid_x = b * hkv * -(-g // gt)
    if n_split is None:
        n_split = plan_splits(grid_x, s, n_sm)
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split must be in 1..{MAX_SPLIT}, got {n_split}")
    smem = smem_bytes(gs, gt, hd, n_split)
    if smem > SMEM_BYTES:
        raise ValueError(f"{gt} heads of head_dim {hd} exceed a block's "
                         "shared memory")
    return Plan(vec, nv, gs, gt, n_split, (grid_x, n_split), smem)


def _check(q, k, v, lengths, softcap):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, hd) and k, v (B, S, Hkv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or hq % k.shape[2]:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (batch, head_dim, Hq a multiple "
                         "of Hkv)")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q and the cache must be float32 or bfloat16 (k and v "
                        f"alike), got {q.dtype}, {k.dtype}, {v.dtype}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, *, softcap: float | None = None,
                      scale: float | None = None,
                      n_split: int | None = None) -> torch.Tensor:
    """One token's attention over the first `lengths[b]` cache slots ->
    (B, Hq, hd) in q's dtype (float32 math); zeros where `lengths[b]` is
    0, on either device.  `n_split` overrides `plan_splits` (1..8) on the
    card."""
    _check(q, k, v, lengths, softcap)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, lengths, softcap=softcap,
                                scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    ptrs = [build.device_operand(t, n, dev) for t, n in (
        (q, "q"), (k, "k"), (v, "v"), (lengths, "lengths"))]
    out = torch.empty_like(q)
    if b == 0 or hq == 0:
        return out
    plan = plan_launch(q, k, v, _sm_count(dev.index), n_split)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = _fn()(*ptrs, out.data_ptr(), b, hq, hkv, s, hd,
                0.0 if softcap is None else float(softcap), float(scale),
                int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
                plan.vec, plan.nv, plan.gt, plan.gs, plan.n_split,
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_decode"] += 1
    return out
