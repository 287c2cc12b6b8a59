"""Wrapper of the fused MLP kernel (`csrc/fused_mlp.cu`).

  * `fused_mlp_cuda` — one fusion group: x (N, C0) through L dense layers
    with bias (+ReLU) in one launch; replaces the reference's
    `fused_mlp_pallas`.

A CPU tensor goes to the plain version (`ref.py`) and the launch count does
not move.  A CUDA tensor launches the kernel on the current stream, or
raises; the output is allocated here with `torch.empty` and nothing
synchronises.  `LAUNCHES` counts kernel launches.

The planner's `tile_points` is a TPU notion and is not used here: the
kernel's row tile (`row_tile`) is the largest of 64/32/16/8 rows whose two
activation buffers fit in a block's shared memory, halved (down to 16)
while the grid would not give every SM a block; a single-layer group whose
row tiles still leave SMs idle splits its output columns over more CTAs
(`col_splits`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref

SMEM_BYTES = 232448          # H100: shared memory a block can use
K_CHUNK, COL_TILE = 32, 128  # staged weight chunk (kKc x kCn in the source)
ROW_TILES = (64, 32, 16, 8)  # rows a CTA owns (8 warps x RPW)
MAX_LAYERS = 16
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"fused_mlp": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn():
    fn = build.load("fused_mlp").fused_mlp
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(widths: Sequence[int], rows: int) -> int:
    """Dynamic shared memory of one CTA: the weight chunk plus two
    activation buffers, one for the even layers' inputs and one for the
    odd layers' (the last layer writes from registers)."""
    ins = list(widths[:-1])
    per_row = max(ins[0::2]) + max(ins[1::2], default=0)
    return 4 * (K_CHUNK * COL_TILE + rows * per_row)


def row_tile(widths: Sequence[int], n_rows: int, n_sms: int = 132) -> int:
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
    """CTAs that share a row tile's column passes: more than one only for
    a single-layer group (nothing is recomputed) whose row tiles do not
    fill the card."""
    tiles = -(-n_rows // rows)
    if len(widths) != 2 or tiles >= n_sms:
        return 1
    return min(-(-widths[1] // COL_TILE), -(-n_sms // tiles))


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


def fused_mlp_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   final_act: bool = True) -> torch.Tensor:
    """x (N, C0); weights[i] (C_i, C_{i+1}); biases[i] (C_{i+1},); all
    float32 or all bfloat16 -> (N, C_L) in x's dtype."""
    widths = _check(x, weights, biases)
    if x.device.type == "cpu":
        return fused_mlp_ref(x, weights, biases, final_act)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    dev = x.device
    n = x.shape[0]
    xp = build.device_operand(x, "x", dev)
    wp = [build.device_operand(w, f"weights[{i}]", dev)
          for i, w in enumerate(weights)]
    bp = [build.device_operand(b, f"biases[{i}]", dev)
          for i, b in enumerate(biases)]
    out = torch.empty((n, widths[-1]), dtype=x.dtype, device=dev)
    if n == 0:
        return out
    n_layers = len(weights)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = row_tile(widths, n, n_sms)
    err = _fn()(xp, out.data_ptr(), (_P * n_layers)(*wp),
                (_P * n_layers)(*bp), (_I * (n_layers + 1))(*widths),
                n_layers, n, rows, col_splits(widths, n, rows, n_sms),
                int(x.dtype == torch.bfloat16), int(bool(final_act)),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    LAUNCHES["fused_mlp"] += 1
    return out
