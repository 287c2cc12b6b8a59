"""Wrappers of the fused MLP kernels.

  * `fused_mlp_cuda` — one fusion group: x (N, C0) through L dense layers
    with bias (+ReLU) in one launch; replaces the reference's
    `fused_mlp_pallas`.

It launches the kernel that `plan_mlp` names, from shapes, type, operand
alignment and the SM count only:

  "tc"         `csrc/fused_mlp_tc.cu`, split-float TF32 on the tensor cores,
               the group's weights resident in shared memory, a persistent
               grid over row tiles (every PointNet++(s) group);
  "tc_stream"  the same mainloop with the weights streamed through a ring
               of cp.async stages, for weights over the budget (PointNet's
               128 -> 1024);
  "few_rows"   one layer at most FEW_ROWS rows (PointNet's head at 8 rows):
               32-column tiles, K split over a cluster of up to 8 CTAs,
               float32 FMAs, reduced in rank order;
  "fma"        `csrc/fused_mlp.cu` (`fused_mlp_fma_kernel`, float32 FMAs),
               for operands that are not 16-byte aligned; `row_tile` and
               `col_splits` plan it.

A CPU tensor goes to the plain version (`ref.py`) and the launch counts do
not move.  A CUDA tensor launches a kernel on the current stream, or
raises; the output is allocated here with `torch.empty` and nothing
synchronises.  `LAUNCHES` counts kernel launches: "fused_mlp" every one,
and one count per variant ("fused_mlp_tc", ...).  `fused_mlp_kernel(...,
kind=)` runs one variant alone, for tests and timing.

The planner's `tile_points` is a TPU notion and is not used here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref

SMEM_BYTES = 232448          # H100: shared memory a block can use
SM_BYTES = 233472            # shared memory of an SM; 1 KB of it is reserved a CTA
MAX_LAYERS = 16
DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("tc", "tc_stream", "few_rows", "fma")
# the FMA kernel (csrc/fused_mlp.cu)
K_CHUNK, COL_TILE = 32, 128  # staged weight chunk (kKc x kCn in the source)
ROW_TILES = (64, 32, 16, 8)  # rows a CTA owns (8 warps x RPW)
# the tensor-core kernel (csrc/fused_mlp_tc.cu)
TC_ROWS = (64, 32, 16)       # rows of a tile: R
CTAS_PER_SM = 2              # launch bounds: 256 threads, <= 128 registers
CHUNK = 32                   # K of a fresh fragment and of a ring stage (kChunk)
PASS_COLS = 128              # columns of a pass (kPassTiles n8 tiles)
RING_STRIDE = PASS_COLS + 8  # elements of a ring stage's row (kRingStride)
STAGES = 3                   # ring stages of tc_stream (kStages)
FEW_ROWS = 16                # few_rows: most rows (kFewRows)
FEW_COLS = 32                # few_rows: output columns a CTA (kFewCols)
FEW_CTAS = 128               # few_rows: CTAs the plan aims for
MAX_SPLIT = 8                # few_rows: most CTAs a cluster (the portable size)

LAUNCHES = {"fused_mlp": 0, **{f"fused_mlp_{v}": 0 for v in VARIANTS}}

_P = ctypes.c_void_p
_I = ctypes.c_int
ARGTYPES = {  # the C entries' ctypes signatures
    "fused_mlp": [_P] * 5 + [_I] * 6 + [_P],
    "fused_mlp_tc": [_P] * 5 + [_I] * 9 + [_P],
    "fused_mlp_few_rows": [_P] * 4 + [_I] * 7 + [_P],
}


class MlpPlan(NamedTuple):
    variant: str             # "tc", "tc_stream", "few_rows" or "fma"
    rows: int                # rows of a CTA's tile (few_rows: all of them)
    grid: tuple[int, int]    # (x, y) CTAs
    cluster: int             # CTAs of a cluster along y (few_rows), else 1
    stages: int              # W ring stages (tc_stream), x buffers (tc: 2), else 0
    smem: int                # dynamic shared memory bytes of a CTA

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    fn = getattr(build.load("fused_mlp" if name == "fused_mlp"
                            else "fused_mlp_tc"), name)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(widths: Sequence[int], rows: int) -> int:
    """FMA kernel: dynamic shared memory of one CTA: the weight chunk plus
    two activation buffers, one for the even layers' inputs and one for
    the odd layers' (the last layer writes from registers)."""
    ins = list(widths[:-1])
    per_row = max(ins[0::2]) + max(ins[1::2], default=0)
    return 4 * (K_CHUNK * COL_TILE + rows * per_row)


def row_tile(widths: Sequence[int], n_rows: int, n_sms: int = 132) -> int:
    """FMA kernel: rows a CTA."""
    fits = [r for r in ROW_TILES if smem_bytes(widths, r) <= SMEM_BYTES]
    if not fits:
        raise ValueError(f"widths {list(widths)}: two activation buffers of "
                         f"{ROW_TILES[-1]} rows exceed {SMEM_BYTES} bytes of "
                         "shared memory")
    r = fits[0]
    while r > 16 and r // 2 in fits and -(-n_rows // r) < n_sms:
        r //= 2
    return r


def col_splits(widths: Sequence[int], n_rows: int, rows: int,
               n_sms: int = 132) -> int:
    """FMA kernel: CTAs that share a row tile's column passes: more than
    one only for a single-layer group (nothing is recomputed) whose row
    tiles do not fill the card."""
    tiles = -(-n_rows // rows)
    if len(widths) != 2 or tiles >= n_sms:
        return 1
    return min(-(-widths[1] // COL_TILE), -(-n_sms // tiles))


def _r8(v: int) -> int:
    return -(-v // 8) * 8


def _r4(v: int) -> int:
    return -(-v // 4) * 4


def tc_smem(widths: Sequence[int], rows: int, stream: bool,
            bf16: bool) -> int:
    """Dynamic shared memory of a tensor-core launch of R = `rows`
    (resident W, or `stream`ed), as `layout` in csrc/fused_mlp_tc.cu
    computes it (the C entry refuses a launch whose bytes differ): W in
    fragment order and b, zero padded to multiples of 8; the x tile (rows
    padded to round8(C0) + 4 floats, C0 + 8 bf16, where C0 fills 16-byte
    vectors, else flat) plus 8 words, twice for the resident route; two
    ping-pong buffers of (hi, lo) pairs, round16(C) + 8 a row, buffer j
    holding the input of every layer l >= 1 with (l - 1) % 2 == j; the W
    ring."""
    words = 0
    if not stream:
        for k, n in zip(widths[:-1], widths[1:]):
            words += _r8(k) * _r8(n) + _r8(n)
    c0, esz = widths[0], (2 if bf16 else 4)
    stride = c0 if c0 % (16 // esz) else c0 + 8 if bf16 else _r8(c0) + 4
    words += (1 if stream else 2) * _r4(-(-rows * stride * esz // 4) + 8)
    for j in (0, 1):
        words += 2 * rows * max((-(-widths[i] // 16) * 16 + 8
                                 for i in range(1, len(widths) - 1)
                                 if (i + 1) % 2 == j), default=0)
    if stream:
        words += STAGES * CHUNK * RING_STRIDE * esz // 4
    return 4 * words


def few_smem(ks: int) -> int:
    """few_rows: x's K slice of FEW_ROWS rows, the warps' partial tiles and
    the CTA's (`few_smem` in csrc/fused_mlp_tc.cu)."""
    return 4 * (_r4(FEW_ROWS * ks) + 8 * FEW_ROWS * FEW_COLS
                + FEW_ROWS * FEW_COLS)


def ctas_per_sm(smem: int) -> int:
    """Tensor-core CTAs an SM holds: by shared memory and launch bounds."""
    return min(CTAS_PER_SM, SM_BYTES // (smem + 1024))


def _is_bf16(dtype) -> bool:
    if dtype in (torch.bfloat16, "bfloat16"):
        return True
    if dtype in (torch.float32, "float32"):
        return False
    raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")


def _plan_resident(widths, n_rows, bf16, n_sm):
    """The R that fits with the most rows in flight an SM (R x CTAs an SM),
    then the most CTAs an SM; halved (down to 16) while its tiles do not
    give every SM one."""
    fits = {r: tc_smem(widths, r, False, bf16) for r in TC_ROWS}
    fits = {r: smem for r, smem in fits.items() if smem <= SMEM_BYTES}
    if not fits:
        return None
    *_, rows = max((ctas_per_sm(smem) * r, ctas_per_sm(smem), r)
                   for r, smem in fits.items())
    while rows // 2 in fits and -(-n_rows // rows) < n_sm:
        rows //= 2
    smem = fits[rows]
    return MlpPlan("tc", rows, (min(-(-n_rows // rows),
                                    ctas_per_sm(smem) * n_sm), 1),
                   1, 2, smem)


def _plan_stream(widths, n_rows, bf16, n_sm):
    if bf16 and any(n % 2 for n in widths[1:]):
        return None                       # bf16 W rows copied 4 bytes at a time
    passes = -(-_r8(widths[-1]) // PASS_COLS)

    def splits(r):  # a divisor of the passes, for at least a full card
        if len(widths) != 2:
            return 1
        tiles = -(-n_rows // r)
        return next(d for d in range(1, passes + 1) if passes % d == 0 and (
            d == passes or tiles * d >= CTAS_PER_SM * n_sm))
    ok = [r for r in TC_ROWS if tc_smem(widths, r, True, bf16) <= SMEM_BYTES]
    if not ok:
        return None
    rows = ok[0]              # the largest; halved while the grid leaves SMs idle
    while rows // 2 in ok and -(-n_rows // rows) * splits(rows) < n_sm:
        rows //= 2
    return MlpPlan("tc_stream", rows, (-(-n_rows // rows), splits(rows)), 1,
                   STAGES, tc_smem(widths, rows, True, bf16))


def _plan_fma(widths, n_rows, n_sm):
    rows = row_tile(widths, n_rows, n_sm)
    return MlpPlan("fma", rows, (-(-n_rows // rows),
                                 col_splits(widths, n_rows, rows, n_sm)),
                   1, 0, smem_bytes(widths, rows))


@functools.lru_cache(maxsize=1024)
def plan_mlp(widths: tuple, n_rows: int, dtype, n_sm: int,
             aligned: bool = True) -> MlpPlan:
    """The launch of a fusion group of `widths` (C0, ..., C_L) over
    `n_rows` rows, from shapes, type, operand alignment and the SM count
    only.  Aligned operands take "few_rows" for one layer of at most
    FEW_ROWS rows and C_L % 4 == 0 (32-column tiles x a cluster of up to
    MAX_SPLIT ranks over K, about FEW_CTAS CTAs); else "tc" where W, b
    and the buffers fit a block's shared memory at some R of TC_ROWS
    (`_plan_resident`; persistent: at most CTAS_PER_SM a SM); else
    "tc_stream" (the largest R that fits, halved while the grid leaves SMs
    idle; a single-layer group's passes split over grid y); else "fma"."""
    widths = tuple(int(w) for w in widths)
    bf16 = _is_bf16(dtype)
    k, n = widths[0], widths[-1]
    if aligned and len(widths) == 2 and n_rows <= FEW_ROWS and n % 4 == 0:
        col_tiles = -(-n // FEW_COLS)
        cs = max(1, min(MAX_SPLIT, -(-FEW_CTAS // col_tiles), k))
        if few_smem(-(-k // cs)) <= SMEM_BYTES:
            return MlpPlan("few_rows", n_rows, (col_tiles, cs), cs, 0,
                           few_smem(-(-k // cs)))
    plan = None
    if aligned:
        plan = _plan_resident(widths, n_rows, bf16, n_sm) \
            or _plan_stream(widths, n_rows, bf16, n_sm)
    return plan or _plan_fma(widths, n_rows, n_sm)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, weights: Sequence[torch.Tensor],
             biases: Sequence[torch.Tensor], *,
             n_sm: int | None = None) -> MlpPlan:
    """`plan_mlp` for these operands (shapes, type, and the 16-byte
    alignment of x, every W and every b; `n_sm` defaults to the card's SM
    count)."""
    widths = (x.shape[1],) + tuple(w.shape[1] for w in weights)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *weights, *biases))
    if n_sm is None:
        n_sm = _sm_count(x.device.index)
    return plan_mlp(widths, x.shape[0], x.dtype, n_sm, aligned)


def _check(x, weights, biases):
    if x.dim() != 2:
        raise ValueError(f"expected x (N, C0), got {tuple(x.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"expected 1..{MAX_LAYERS} layers with one bias "
                         f"each, got {len(weights)} weights and "
                         f"{len(biases)} biases")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    widths = [x.shape[1]]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[0] != widths[-1] \
                or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"layer {i}: weights {tuple(w.shape)} and bias "
                f"{tuple(b.shape)} do not continue a chain of width "
                f"{widths[-1]}")
        if w.dtype != x.dtype or b.dtype != x.dtype:
            raise TypeError(f"layer {i}: weights and bias must be {x.dtype}")
        widths.append(w.shape[1])
    return widths


def _launch(x, weights, biases, final_act: bool,
            kind: str | None) -> torch.Tensor:
    """Launch the variant `kind` (None: the one `plan_mlp` names)."""
    widths = _check(x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")
    dev = x.device
    n, n_layers = x.shape[0], len(weights)
    xp = build.device_operand(x, "x", dev)
    wp = [build.device_operand(w, f"weights[{i}]", dev)
          for i, w in enumerate(weights)]
    bp = [build.device_operand(b, f"biases[{i}]", dev)
          for i, b in enumerate(biases)]
    out = torch.empty((n, widths[-1]), dtype=x.dtype, device=dev)
    if n == 0:
        return out
    if kind == "fma":
        plan = _plan_fma(tuple(widths), n, _sm_count(dev.index))
    else:
        plan = plan_for(x, weights, biases)
        if kind is not None and plan.variant != kind:
            raise ValueError(f"variant {plan.variant!r} takes these operands "
                             f"(widths {widths}, {n} rows), not {kind!r}")
    bf16, act = int(x.dtype == torch.bfloat16), int(bool(final_act))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws, bs = (_P * n_layers)(*wp), (_P * n_layers)(*bp)
    dims = (_I * (n_layers + 1))(*widths)
    if plan.variant == "fma":
        err = _fn("fused_mlp")(xp, out.data_ptr(), ws, bs, dims, n_layers, n,
                               plan.rows, plan.grid[1], bf16, act, stream)
    elif plan.variant == "few_rows":
        err = _fn("fused_mlp_few_rows")(
            xp, out.data_ptr(), wp[0], bp[0], n, widths[0], widths[1],
            plan.cluster, bf16, act, plan.smem, stream)
    else:
        err = _fn("fused_mlp_tc")(xp, out.data_ptr(), ws, bs, dims, n_layers,
                                  n, int(plan.variant == "tc_stream"),
                                  plan.rows, plan.grid[0],
                                  plan.grid[1], bf16, act, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_{plan.variant} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["fused_mlp"] += 1
    LAUNCHES[f"fused_mlp_{plan.variant}"] += 1
    return out


def fused_mlp_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   final_act: bool = True) -> torch.Tensor:
    """x (N, C0); weights[i] (C_i, C_{i+1}); biases[i] (C_{i+1},); all
    float32 or all bfloat16 -> (N, C_L) in x's dtype, through the kernel
    `plan_mlp` names."""
    _check(x, weights, biases)
    if x.device.type == "cpu":
        return fused_mlp_ref(x, weights, biases, final_act)
    return _launch(x, weights, biases, final_act, None)


def fused_mlp_kernel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], final_act: bool = True,
                     *, kind: str) -> torch.Tensor:
    """One variant `kind` of VARIANTS, CUDA tensors only: "fma" always,
    another where `plan_mlp` gives it these operands, else raises.  For
    tests and for timing one kernel beside another."""
    if kind not in VARIANTS:
        raise ValueError(f"kind must be one of {VARIANTS}, got {kind!r}")
    return _launch(x, weights, biases, final_act, kind)
