"""Wrappers of the grouped matmul kernels (`csrc/grouped_matmul_wgmma.cu`,
`csrc/grouped_matmul.cu`, and the weight gradient's
`csrc/grouped_matmul_dw_wgmma.cu` and `csrc/grouped_matmul_dw.cu`).

  * `grouped_matmul_cuda` — x (R, Cin) rows sorted and padded by expert,
    tile_eid (R // row_tile,) the expert of each row tile, weights
    (E, Cin, Cout) -> (R, Cout); replaces the reference's
    `grouped_matmul_pallas`.  It launches the kernel that `variant` names:
  * `grouped_matmul_wgmma` — bf16 on the tensor cores (wgmma fed by TMA),
    for bf16 with Cin and Cout multiples of 8 and a row tile a multiple of
    128: every shape of the LM path;
  * `grouped_matmul_fma` — float32 FMAs, for everything else (float32, so
    no TF32; bf16 at odd widths); row tiles a multiple of 64.

Training adds two launches a call (`ops.grouped_matmul`'s backward):
  * `grouped_matmul_dx_cuda` — dX = dY @ W^T: the forward kernel above on
    dY with the weights transposed to (E, Cout, Cin);
  * `grouped_matmul_dw_cuda` — dW[e] = sum of x_i^T dY_i over the row tiles
    of expert e, no atomics, through the kernel that `dw_variant` names:
  * `grouped_matmul_dw_wgmma` — bf16 on the tensor cores (wgmma fed by
    TMA; a persistent grid walks 128 x 256 tiles of dW[e], stored
    by TMA), for bf16 with Cin and Cout multiples of 8 and a row tile a
    multiple of 64: every shape of the train step;
  * `grouped_matmul_dw_fma` — float32 FMAs (one CTA a 64 x 128 tile of
    dW[e]), for everything else; row tiles a multiple of 16.

The choice depends on dtype and shape only, never on a failure: a refused
launch raises.  A CPU tensor goes to the plain version
(`ref.grouped_matmul_ref`, `ref.grouped_matmul_dw_ref`) and no count
moves.  A CUDA tensor launches a kernel on the current stream, or raises.
The kernels take `tile_eid` as given (no equal segments assumed); an id out
of range follows the reference's rule in every path (`ref.expert_ids`: a
negative id wraps once, then clamps to [0, E - 1]).
`LAUNCHES` counts kernel launches: "grouped_matmul" every launch of the
forward kernels (dX's too), one count per variant, "grouped_matmul_dx"
the dX launches among them, and "grouped_matmul_dw" the weight-gradient
kernels', one count per variant ("grouped_matmul_dw_wgmma" /
"grouped_matmul_dw_fma").

A CUDA call goes through a dispatcher op (`kernels/build.define_op`):
`repro_torch::grouped_matmul` (the forward and dX, `dx` marking dX's
launches) and `repro_torch::grouped_matmul_dw`.  Their CUDA
implementations pick the variant and launch; on fake tensors the fake
implementations give the output's shape and dtype, and the FLOP formula
counts what the kernel computes, 2 x R x Cin x Cout over every row tile
(padding rows included).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_dw_ref,
                                                   grouped_matmul_ref)

FMA_ROWS_PER_CTA = 64
WGMMA_ROWS_PER_CTA = 128
WGMMA_K_STEP = 64          # input channels a pipeline stage of the wgmma kernel
DTYPES = (torch.float32, torch.bfloat16)

DW_ROWS_PER_STEP = 16      # rows the FMA weight-gradient kernel stages a step
DW_WGMMA_K_STEP = 64       # rows a pipeline stage of the wgmma weight gradient

LAUNCHES = {"grouped_matmul": 0, "grouped_matmul_wgmma": 0,
            "grouped_matmul_fma": 0, "grouped_matmul_dx": 0,
            "grouped_matmul_dw": 0, "grouped_matmul_dw_wgmma": 0,
            "grouped_matmul_dw_fma": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
             "fma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}
_ARGTYPES["dw_fma"], _ARGTYPES["dw_wgmma"] = _ARGTYPES["fma"], _ARGTYPES["wgmma"]
_SOURCES = {"wgmma": "grouped_matmul_wgmma", "fma": "grouped_matmul",
            "dw_fma": "grouped_matmul_dw", "dw_wgmma": "grouped_matmul_dw_wgmma"}


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


def dw_variant(dtype: torch.dtype, cin: int, cout: int, row_tile: int) -> str:
    """The weight-gradient kernel a CUDA call takes: "wgmma" for bf16 with
    Cin and Cout multiples of 8 (TMA strides are multiples of 16 bytes) and
    row_tile a multiple of 64 (a 64-row K step lies in one row tile), else
    "fma"."""
    if (dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
            and row_tile % DW_WGMMA_K_STEP == 0):
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


def _launch(kind, x, tile_eid, weights, row_tile, dx=False):
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
    if dx:
        LAUNCHES["grouped_matmul_dx"] += 1
    return out


def _cuda(x, tile_eid, weights, row_tile, dx, kind):
    """The forward op's CUDA implementation: "auto" launches the kernel
    `variant` picks, "wgmma" the tensor-core kernel (raising where
    `variant` would not pick it), "fma" the FMA kernel."""
    chosen = variant(x.dtype, x.shape[1], weights.shape[2], row_tile)
    if kind == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the tensor-core kernel takes bf16 with Cin, Cout "
                         f"multiples of 8 and row tiles of a multiple of "
                         f"{WGMMA_ROWS_PER_CTA}; got {x.dtype}, "
                         f"{x.shape[1]} -> {weights.shape[2]}, {row_tile}")
    return _launch(chosen if kind == "auto" else kind, x, tile_eid, weights,
                   row_tile, dx=dx)


def _fake(x, tile_eid, weights, row_tile, dx, kind):
    return x.new_empty((x.shape[0], weights.shape[2]))


def matmul_flops(x, tile_eid, weights, row_tile, dx, kind,
                 out_shape=None) -> int:
    """2 x R x Cin x Cout: every row tile against its expert's weights."""
    return 2 * x[0] * x[1] * weights[2]


_OP = build.define_op(
    "grouped_matmul(Tensor x, Tensor tile_eid, Tensor weights, int row_tile, "
    "bool dx, str kind) -> Tensor", _cuda, _fake, matmul_flops)


def grouped_matmul_cuda(x: torch.Tensor, tile_eid: torch.Tensor,
                        weights: torch.Tensor,
                        row_tile: int = 128) -> torch.Tensor:
    """Row tile i of x times weights[tile_eid[i]] -> (R, Cout) in x's dtype
    (float32 sums), through the kernel `variant` picks."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    return _OP(x, tile_eid, weights, row_tile, False, "auto")


def grouped_matmul_wgmma(x: torch.Tensor, tile_eid: torch.Tensor,
                         weights: torch.Tensor,
                         row_tile: int = 128) -> torch.Tensor:
    """`grouped_matmul_cuda` through the tensor-core kernel; raises where
    `variant` does not pick it."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    return _OP(x, tile_eid, weights, row_tile, False, "wgmma")


def grouped_matmul_fma(x: torch.Tensor, tile_eid: torch.Tensor,
                       weights: torch.Tensor,
                       row_tile: int = 128) -> torch.Tensor:
    """`grouped_matmul_cuda` through the float32-FMA kernel, whatever the
    shape."""
    _check(x, tile_eid, weights, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, tile_eid, weights, row_tile)
    return _OP(x, tile_eid, weights, row_tile, False, "fma")


def grouped_matmul_dx_cuda(dy: torch.Tensor, tile_eid: torch.Tensor,
                           weights: torch.Tensor,
                           row_tile: int = 128) -> torch.Tensor:
    """The input gradient of `grouped_matmul_cuda`: dY (R, Cout) times the
    transpose of weights[tile_eid[i]] on row tile i -> (R, Cin), through
    the forward kernel that `variant` picks for the transposed shape."""
    w_t = weights.transpose(1, 2).contiguous()
    _check(dy, tile_eid, w_t, row_tile)
    if dy.device.type == "cpu":
        return grouped_matmul_ref(dy, tile_eid, w_t, row_tile)
    return _OP(dy, tile_eid, w_t, row_tile, True, "auto")


def _check_dw(x, dy, tile_eid, n_experts, row_tile):
    if x.dim() != 2 or dy.dim() != 2 or tile_eid.dim() != 1 \
            or dy.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (R, Cin), dy (R, Cout), tile_eid "
                         f"(R // row_tile,); got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}, {tuple(tile_eid.shape)}")
    r = x.shape[0]
    if row_tile < 1 or r % row_tile or tile_eid.shape[0] != r // row_tile:
        raise ValueError(f"{r} rows are not {tile_eid.shape[0]} tiles of "
                         f"{row_tile}")
    if x.dtype not in DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must both be float32 or both bfloat16, "
                        f"got {x.dtype}, {dy.dtype}")
    if n_experts < 1:
        raise ValueError(f"n_experts must be >= 1, got {n_experts}")


def _launch_dw(kind, x, dy, tile_eid, n_experts, row_tile):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if kind == "fma" and row_tile % DW_ROWS_PER_STEP:
        raise ValueError(f"the FMA weight-gradient kernel takes row tiles "
                         f"that are multiples of {DW_ROWS_PER_STEP}, got "
                         f"{row_tile}")
    if tile_eid.dtype != torch.int32:
        raise TypeError(f"tile_eid must be int32, got {tile_eid.dtype}")
    dev = x.device
    ptrs = [build.device_operand(t, n, dev) for t, n in (
        (x, "x"), (dy, "dy"), (tile_eid, "tile_eid"))]
    if kind == "wgmma" and (ptrs[0] | ptrs[1]) % 16:
        raise ValueError("the tensor-core weight-gradient kernel takes x and "
                         "dy on 16-byte boundaries (TMA)")
    r, cin = x.shape
    cout = dy.shape[1]
    out = torch.empty((n_experts, cin, cout), dtype=x.dtype, device=dev)
    extra = () if kind == "wgmma" else (int(x.dtype == torch.bfloat16),)
    err = _fn(f"dw_{kind}")(*ptrs, out.data_ptr(), r, cin, cout, n_experts,
                            row_tile, *extra,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul_dw ({kind}) kernel launch failed: "
                           f"error {err} (a cudaError_t; -1: libcuda has no "
                           f"cuTensorMapEncodeTiled, -2: it refused a "
                           f"tensor map)")
    LAUNCHES["grouped_matmul_dw"] += 1
    LAUNCHES[f"grouped_matmul_dw_{kind}"] += 1
    return out


def _cuda_dw(x, dy, tile_eid, n_experts, row_tile, kind):
    """The weight-gradient op's CUDA implementation: "auto" launches the
    kernel `dw_variant` picks, "wgmma" the tensor-core kernel (raising
    where `dw_variant` would not pick it), "fma" the FMA kernel."""
    chosen = dw_variant(x.dtype, x.shape[1], dy.shape[1], row_tile)
    if kind == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the tensor-core weight-gradient kernel takes bf16 "
                         f"with Cin, Cout multiples of 8 and row tiles of a "
                         f"multiple of {DW_WGMMA_K_STEP}; got {x.dtype}, "
                         f"{x.shape[1]} -> {dy.shape[1]}, {row_tile}")
    return _launch_dw(chosen if kind == "auto" else kind, x, dy, tile_eid,
                      n_experts, row_tile)


def _fake_dw(x, dy, tile_eid, n_experts, row_tile, kind):
    return x.new_empty((n_experts, x.shape[1], dy.shape[1]))


def dw_flops(x, dy, tile_eid, n_experts, row_tile, kind,
             out_shape=None) -> int:
    """2 x R x Cin x Cout: every row's x_i^T dY_i, summed per expert."""
    return 2 * x[0] * x[1] * dy[1]


_OP_DW = build.define_op(
    "grouped_matmul_dw(Tensor x, Tensor dy, Tensor tile_eid, int n_experts, "
    "int row_tile, str kind) -> Tensor", _cuda_dw, _fake_dw, dw_flops)


def grouped_matmul_dw_cuda(x: torch.Tensor, dy: torch.Tensor,
                           tile_eid: torch.Tensor, n_experts: int,
                           row_tile: int = 128) -> torch.Tensor:
    """The weight gradient of `grouped_matmul_cuda`: x (R, Cin), dY (R,
    Cout) -> dW (E, Cin, Cout) in x's dtype, dW[e] = sum of x_i^T dY_i over
    the row tiles whose expert is e (ids resolved as the forward resolves
    them; float32 sums; zeros for an expert without tiles), through the
    kernel that `dw_variant` picks."""
    _check_dw(x, dy, tile_eid, n_experts, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, tile_eid, n_experts, row_tile)
    return _OP_DW(x, dy, tile_eid, n_experts, row_tile, "auto")


def grouped_matmul_dw_wgmma(x: torch.Tensor, dy: torch.Tensor,
                            tile_eid: torch.Tensor, n_experts: int,
                            row_tile: int = 128) -> torch.Tensor:
    """`grouped_matmul_dw_cuda` through the tensor-core kernel; raises where
    `dw_variant` does not pick it."""
    _check_dw(x, dy, tile_eid, n_experts, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, tile_eid, n_experts, row_tile)
    return _OP_DW(x, dy, tile_eid, n_experts, row_tile, "wgmma")


def grouped_matmul_dw_fma(x: torch.Tensor, dy: torch.Tensor,
                          tile_eid: torch.Tensor, n_experts: int,
                          row_tile: int = 128) -> torch.Tensor:
    """`grouped_matmul_dw_cuda` through the float32-FMA kernel, whatever the
    dtype and widths."""
    _check_dw(x, dy, tile_eid, n_experts, row_tile)
    if x.device.type == "cpu":
        return grouped_matmul_dw_ref(x, dy, tile_eid, n_experts, row_tile)
    return _OP_DW(x, dy, tile_eid, n_experts, row_tile, "fma")
