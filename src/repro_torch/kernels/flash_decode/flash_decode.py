"""Wrapper of the flash-decode kernel (`csrc/flash_decode.cu`).

  * `flash_decode_cuda` — q (B, Hq, hd) against a cache k/v (B, S, Hkv, hd)
    masked by per-sequence `lengths` (B,) -> (B, Hq, hd); replaces the
    reference's `flash_decode_pallas`.

A CPU tensor goes to the plain version (`ref.flash_decode_ref`) and the
launch count does not move.  A CUDA tensor launches the kernel on the
current stream, or raises.  The kernel reads no slot at or past
`lengths[b]` and masks the ragged last tile, so the cache is not padded.
`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

DTYPES = (torch.float32, torch.bfloat16)
SMEM_BYTES = 232448
TILE = 64                    # cache positions a kv tile

LAUNCHES = {"flash_decode": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn():
    fn = build.load("flash_decode").flash_decode
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                       _P]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(g: int, hd: int) -> int:
    """Shared memory of one CTA: q, the K (padded) and V tiles, the tile's
    scores, the accumulator and three statistics per head, in float32."""
    return 4 * (g * hd + TILE * (hd + 1) + TILE * hd + g * TILE + g * hd
                + 3 * g)


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
                      scale: float | None = None) -> torch.Tensor:
    """One token's attention over the first `lengths[b]` cache slots ->
    (B, Hq, hd) in q's dtype (float32 math); zeros where `lengths[b]` is
    0, on either device."""
    _check(q, k, v, lengths, softcap)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, lengths, softcap=softcap,
                                scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if smem_bytes(hq // hkv, hd) > SMEM_BYTES:
        raise ValueError(f"{hq // hkv} heads of head_dim {hd} exceed a block's "
                         "shared memory")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    dev = q.device
    ptrs = [build.device_operand(t, n, dev) for t, n in (
        (q, "q"), (k, "k"), (v, "v"), (lengths, "lengths"))]
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    err = _fn()(*ptrs, out.data_ptr(), b, hq, hkv, s, hd,
                0.0 if softcap is None else float(softcap), float(scale),
                int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_decode"] += 1
    return out
