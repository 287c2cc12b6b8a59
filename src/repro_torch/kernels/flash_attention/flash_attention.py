"""Wrapper of the flash attention kernel (`csrc/flash_attention.cu`).

  * `flash_attention_cuda` — q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D); replaces the reference's `flash_attention_pallas`.

A CPU tensor goes to the plain version (`ref.attention_ref`) and the launch
count does not move.  A CUDA tensor launches the kernel on the current
stream, or raises; the output is allocated here and nothing synchronises.
Unlike the Pallas kernel, Sq and Skv need not be multiples of a block: the
kernel masks the ragged edges.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

ROWS_PER_CTA = 64            # query rows of a CTA: G heads x 64 / G positions
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                       _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
                         " (batch, head_dim, Hq a multiple of Hkv)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Causal / sliding-window / soft-capped GQA attention -> (B, Hq, Sq, D)
    in q's dtype (float32 math)."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d % 8 or d > 256 or hq // hkv > ROWS_PER_CTA:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 up to 256 "
                         f"and at most {ROWS_PER_CTA} query heads a kv head, "
                         f"got head_dim {d}, {hq // hkv} heads")
    dev = q.device
    ptrs = [build.device_operand(t, n, dev) for t, n in ((q, "q"), (k, "k"),
                                                    (v, "v"))]
    out = torch.empty_like(q)
    if b * hq * sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    err = _fn()(*ptrs, out.data_ptr(), b, hq, hkv, sq, skv, d, int(causal),
                0 if window is None else int(window),
                0.0 if softcap is None else float(softcap), float(scale),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
