"""Wrapper of the grouped matmul kernel (`csrc/grouped_matmul.cu`).

  * `grouped_matmul_cuda` — x (R, Cin) rows sorted and padded by expert,
    tile_eid (R // row_tile,) the expert of each row tile, weights
    (E, Cin, Cout) -> (R, Cout); replaces the reference's
    `grouped_matmul_pallas`.

A CPU tensor goes to the plain version (`ref.grouped_matmul_ref`) and the
launch count does not move.  A CUDA tensor launches the kernel on the
current stream, or raises.  The kernel takes `tile_eid` as given (no equal
segments assumed); on the card `row_tile` must be a multiple of its 64-row
CTA tile.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

ROWS_PER_CTA = 64
COLS_PER_CTA = 128
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"grouped_matmul": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn():
    fn = build.load("grouped_matmul").grouped_matmul
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(x, tile_eid, weights, row_tile):
    if x.dim() != 2 or weights.dim() != 3 or tile_eid.dim() != 1:
        raise ValueError(f"expected x (R, Cin), tile_eid (R // row_tile,), "
                         f"weights (E, Cin, Cout); got {tuple(x.shape)}, "
                         f"{tuple(tile_eid.shape)}, {tuple(weights.shape)}")
    r, cin = x.shape
    if row_tile < 1 or r % row_tile or tile_eid.shape[0] != r // row_tile:
        raise ValueError(f"{r} rows are not {tile_eid.shape[0]} tiles of "
                         f"{row_tile}")
    if weights.shape[1] != cin:
        raise ValueError(f"weights {tuple(weights.shape)} do not take Cin = "
                         f"{cin}")
    if x.dtype not in DTYPES or weights.dtype != x.dtype:
        raise TypeError(f"x and weights must both be float32 or both bfloat16, "
                        f"got {x.dtype}, {weights.dtype}")


def grouped_matmul_cuda(x: torch.Tensor, tile_eid: torch.Tensor,
                        weights: torch.Tensor,
                        row_tile: int = 128) -> torch.Tensor:
    """Row tile i of x times weights[tile_eid[i]] -> (R, Cout) in x's dtype
    (float32 sums)."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if row_tile % ROWS_PER_CTA:
        raise ValueError(f"the kernel takes row tiles that are multiples of "
                         f"{ROWS_PER_CTA} rows, got {row_tile}")
    if tile_eid.dtype != torch.int32:
        raise TypeError(f"tile_eid must be int32, got {tile_eid.dtype}")
    dev = x.device
    ptrs = [build.device_operand(t, n, dev) for t, n in (
        (x, "x"), (tile_eid, "tile_eid"), (weights, "weights"))]
    r, cin = x.shape
    e, _, cout = weights.shape
    out = torch.empty((r, cout), dtype=x.dtype, device=dev)
    if r == 0 or cout == 0:
        return out
    err = _fn()(*ptrs, out.data_ptr(), r, cin, cout, e, row_tile,
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"grouped_matmul kernel launch failed: CUDA error {err}")
    LAUNCHES["grouped_matmul"] += 1
    return out
