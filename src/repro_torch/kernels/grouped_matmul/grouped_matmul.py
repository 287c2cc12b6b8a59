"""Wrappers of the grouped matmul kernels (`csrc/grouped_matmul_wgmma.cu`,
`csrc/grouped_matmul.cu`).

  * `grouped_matmul_cuda` — x (R, Cin) rows sorted and padded by expert,
    tile_eid (R // row_tile,) the expert of each row tile, weights
    (E, Cin, Cout) -> (R, Cout); replaces the reference's
    `grouped_matmul_pallas`.  It launches the kernel that `variant` names:
  * `grouped_matmul_wgmma` — bf16 on the tensor cores (wgmma fed by TMA),
    for bf16 with Cin and Cout multiples of 8 and a row tile a multiple of
    128: every shape of the LM path;
  * `grouped_matmul_fma` — float32 FMAs, for everything else (float32, so
    no TF32; bf16 at odd widths); row tiles a multiple of 64.

The choice depends on dtype and shape only, never on a failure: a refused
launch raises.  A CPU tensor goes to the plain version
(`ref.grouped_matmul_ref`) and no count moves.  A CUDA tensor launches a
kernel on the current stream, or raises.  The kernels take `tile_eid` as
given (no equal segments assumed); an id out of range follows the
reference's rule in every path (`ref.expert_ids`: a negative id wraps once,
then clamps to [0, E - 1]).
`LAUNCHES` counts kernel launches: "grouped_matmul" every one, and one
count per variant.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

FMA_ROWS_PER_CTA = 64
WGMMA_ROWS_PER_CTA = 128
WGMMA_K_STEP = 64          # input channels a pipeline stage of the wgmma kernel
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"grouped_matmul": 0, "grouped_matmul_wgmma": 0,
            "grouped_matmul_fma": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
             "fma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}
_SOURCES = {"wgmma": "grouped_matmul_wgmma", "fma": "grouped_matmul"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def variant(dtype: torch.dtype, cin: int, cout: int, row_tile: int) -> str:
    """The kernel a CUDA call takes: "wgmma" for bf16 with Cin and Cout
    multiples of 8 (TMA strides are multiples of 16 bytes) and row_tile a
    multiple of 128 (a CTA's rows lie in one row tile), else "fma"."""
    if (dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
            and row_tile % WGMMA_ROWS_PER_CTA == 0):
        return "wgmma"
    return "fma"


def _fn(kind):
    fn = getattr(build.load(_SOURCES[kind]), _SOURCES[kind])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[kind]
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


def _launch(kind, x, tile_eid, weights, row_tile):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if kind == "fma" and row_tile % FMA_ROWS_PER_CTA:
        raise ValueError(f"the FMA kernel takes row tiles that are multiples "
                         f"of {FMA_ROWS_PER_CTA} rows, got {row_tile}")
    if tile_eid.dtype != torch.int32:
        raise TypeError(f"tile_eid must be int32, got {tile_eid.dtype}")
    dev = x.device
    ptrs = [build.device_operand(t, n, dev) for t, n in (
        (x, "x"), (tile_eid, "tile_eid"), (weights, "weights"))]
    if kind == "wgmma" and (ptrs[0] | ptrs[2]) % 16:
        raise ValueError("the tensor-core kernel takes x and weights on "
                         "16-byte boundaries (TMA)")
    r, cin = x.shape
    e, _, cout = weights.shape
    out = torch.empty((r, cout), dtype=x.dtype, device=dev)
    if r == 0 or cout == 0:
        return out
    extra = () if kind == "wgmma" else (int(x.dtype == torch.bfloat16),)
    err = _fn(kind)(*ptrs, out.data_ptr(), r, cin, cout, e, row_tile, *extra,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul ({kind}) kernel launch failed: "
                           f"error {err} (a cudaError_t; -1: libcuda has no "
                           f"cuTensorMapEncodeTiled, -2: it refused a "
                           f"tensor map)")
    LAUNCHES["grouped_matmul"] += 1
    LAUNCHES[f"grouped_matmul_{kind}"] += 1
    return out


def grouped_matmul_cuda(x: torch.Tensor, tile_eid: torch.Tensor,
                        weights: torch.Tensor,
                        row_tile: int = 128) -> torch.Tensor:
    """Row tile i of x times weights[tile_eid[i]] -> (R, Cout) in x's dtype
    (float32 sums), through the kernel `variant` picks."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    kind = variant(x.dtype, x.shape[1], weights.shape[2], row_tile)
    return _launch(kind, x, tile_eid, weights, row_tile)


def grouped_matmul_wgmma(x: torch.Tensor, tile_eid: torch.Tensor,
                         weights: torch.Tensor,
                         row_tile: int = 128) -> torch.Tensor:
    """`grouped_matmul_cuda` through the tensor-core kernel; raises where
    `variant` does not pick it."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    if variant(x.dtype, x.shape[1], weights.shape[2], row_tile) != "wgmma":
        raise ValueError(f"the tensor-core kernel takes bf16 with Cin, Cout "
                         f"multiples of 8 and row tiles of a multiple of "
                         f"{WGMMA_ROWS_PER_CTA}; got {x.dtype}, "
                         f"{x.shape[1]} -> {weights.shape[2]}, {row_tile}")
    return _launch("wgmma", x, tile_eid, weights, row_tile)


def grouped_matmul_fma(x: torch.Tensor, tile_eid: torch.Tensor,
                       weights: torch.Tensor,
                       row_tile: int = 128) -> torch.Tensor:
    """`grouped_matmul_cuda` through the float32-FMA kernel, whatever the
    shape."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    return _launch("fma", x, tile_eid, weights, row_tile)
