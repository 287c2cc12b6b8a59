"""Wrappers of the flash attention kernels (`csrc/flash_attention_wgmma.cu`,
`csrc/flash_attention.cu`).

  * `flash_attention_cuda` — q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D); replaces the reference's `flash_attention_pallas`.  It
    launches the kernel that `variant` names:
  * `flash_attention_wgmma` — bf16 on the tensor cores (wgmma fed by TMA),
    for bf16 with head_dim 64, 128, 192 or 256, G = Hq / Hkv a power of two
    up to 16 and every operand on a 16-byte boundary: the LM prefill;
  * `flash_attention_fma` — float32 FMAs, for everything else (float32, so
    no TF32; other head_dims, groups or alignments); head_dim a multiple of
    8 up to 256, G up to 64.

The choice depends on dtype, shape and alignment only, never on a failure:
a refused launch raises.  A CPU tensor goes to the plain version
(`ref.attention_ref`) and no count moves.  A CUDA tensor launches a kernel
on the current stream, or raises; the output is allocated here and nothing
synchronises.  Unlike the Pallas kernel, Sq and Skv need not be multiples
of a block: the kernels mask the ragged edges.  `LAUNCHES` counts kernel
launches: "flash_attention" every one, and one count per variant.

A CUDA call goes through the dispatcher op `repro_torch::flash_attention`
(`kernels/build.define_op`): its CUDA implementation picks the variant and
launches; on fake tensors its fake implementation gives the output's
shape and dtype, and its FLOP formula counts the (query, key) pairs the
causal mask and the window keep (`attention_flops`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

FMA_ROWS_PER_CTA = 64        # query rows of an FMA CTA: G heads x 64 / G positions
WGMMA_HEAD_DIMS = (64, 128, 192, 256)   # whole 128-byte rows of bf16
WGMMA_GROUPS = (1, 2, 4, 8, 16)         # a CTA's 128 rows: 128 / G positions,
                                        # a multiple of 8
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_fma": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                       _P],
             "fma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                     _I, _P]}
_SOURCES = {"wgmma": "flash_attention_wgmma", "fma": "flash_attention"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def variant(dtype: torch.dtype, head_dim: int, g: int,
            ptrs_mod_16: Sequence[int]) -> str:
    """The kernel a CUDA call takes: "wgmma" for bf16 with head_dim in
    WGMMA_HEAD_DIMS (TMA boxes of whole 128-byte rows), G in WGMMA_GROUPS
    (a CTA's 128 rows hold G heads at 128 / G positions, a multiple of 8)
    and every operand's `data_ptr() % 16` zero (TMA); else "fma"."""
    if (dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
            and g in WGMMA_GROUPS and not any(ptrs_mod_16)):
        return "wgmma"
    return "fma"


def _fn(kind):
    fn = getattr(build.load(_SOURCES[kind]), f"flash_attention_{kind}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[kind]
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


def _variant_of(q, k, v) -> str:
    return variant(q.dtype, q.shape[3], q.shape[1] // k.shape[1],
                   [t.data_ptr() % 16 for t in (q, k, v)])


def _launch(kind, q, k, v, causal, window, softcap, scale):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if kind == "fma" and (d % 8 or d > 256 or hq // hkv > FMA_ROWS_PER_CTA):
        raise ValueError(f"the FMA kernel takes head_dim a multiple of 8 up to "
                         f"256 and at most {FMA_ROWS_PER_CTA} query heads a kv "
                         f"head, got head_dim {d}, {hq // hkv} heads")
    dev = q.device
    ptrs = [build.device_operand(t, n, dev) for t, n in ((q, "q"), (k, "k"),
                                                    (v, "v"))]
    out = torch.empty_like(q)
    if b * hq * sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    extra = () if kind == "wgmma" else (int(q.dtype == torch.bfloat16),)
    err = _fn(kind)(*ptrs, out.data_ptr(), b, hq, hkv, sq, skv, d, int(causal),
                    0 if window is None else int(window),
                    0.0 if softcap is None else float(softcap), float(scale),
                    *extra, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) kernel launch failed: "
                           f"error {err} (a cudaError_t; -1: libcuda has no "
                           f"cuTensorMapEncodeTiled, -2: it refused a tensor "
                           f"map)")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{kind}"] += 1
    return out


def _cuda(q, k, v, causal, window, softcap, scale, kind):
    """The op's CUDA implementation: "auto" launches the kernel `variant`
    picks, "wgmma" the tensor-core kernel (raising where `variant` would
    not pick it), "fma" the FMA kernel."""
    chosen = _variant_of(q, k, v)
    if kind == "wgmma" and chosen != "wgmma":
        raise ValueError(f"the tensor-core kernel takes bf16 with head_dim in "
                         f"{WGMMA_HEAD_DIMS}, G in {WGMMA_GROUPS} and 16-byte "
                         f"aligned operands; got {q.dtype}, head_dim "
                         f"{q.shape[3]}, G {q.shape[1] // k.shape[1]}")
    return _launch(chosen if kind == "auto" else kind, q, k, v, causal,
                   window, softcap, scale)


def _fake(q, k, v, causal, window, softcap, scale, kind):
    return torch.empty_like(q)


@functools.lru_cache(maxsize=256)
def kept_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps for one head: key j of query i
    where j <= i (causal) and i - j < window (windowed), as `ref._logits`
    masks them."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def attention_flops(q, k, v, causal, window, softcap, scale, kind,
                    out_shape=None) -> int:
    """FLOPs of one call from the operands' shapes: QK^T and PV over the
    kept pairs, 2 x 2 x D a pair and query head."""
    b, hq, sq, d = q
    return 4 * b * hq * d * kept_pairs(sq, k[2], bool(causal), window)


_OP = build.define_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int? window, "
    "float? softcap, float? scale, str kind) -> Tensor",
    _cuda, _fake, attention_flops)


def _call(q, k, v, causal, window, softcap, scale, kind):
    return _OP(q, k, v, bool(causal), window,
               None if softcap is None else float(softcap),
               None if scale is None else float(scale), kind)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Causal / sliding-window / soft-capped GQA attention -> (B, Hq, Sq, D)
    in q's dtype (float32 sums), through the kernel `variant` picks."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    return _call(q, k, v, causal, window, softcap, scale, "auto")


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """`flash_attention_cuda` through the tensor-core kernel; raises where
    `variant` does not pick it."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    return _call(q, k, v, causal, window, softcap, scale, "wgmma")


def flash_attention_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """`flash_attention_cuda` through the float32-FMA kernel, whatever the
    dtype (head_dim a multiple of 8 up to 256)."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    return _call(q, k, v, causal, window, softcap, scale, "fma")
