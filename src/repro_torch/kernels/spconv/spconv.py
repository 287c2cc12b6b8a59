"""Wrappers of the fetch-on-demand sparse conv kernels (`csrc/spconv.cu`).

  * `spconv_fod_cuda`       — the sum alone (`flow="cuda"`); replaces the
    reference's `spconv_fod_pallas`.
  * `spconv_fod_fused_cuda` — the sum with the epilogue folded into the
    flush (`flow="cuda_fused"`); replaces `spconv_fod_fused_pallas`.

A CPU tensor goes to the plain version (`ref.py`) and the launch count does
not move.  A CUDA tensor launches the kernel on the current stream, or
raises; the output is allocated here with `torch.empty` and nothing
synchronises.  `LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sparseconv import Epilogue
from repro_torch.kernels import build
from repro_torch.kernels.spconv.ref import spconv_fod_fused_ref, spconv_fod_ref

MAX_FUSED_COUT = 256   # one CTA owns the whole Cout row (layernorm needs it)
ROWS_PER_CTA = 64      # output rows a CTA owns (kRows in csrc/spconv.cu)

LAUNCHES = {"spconv_fod": 0, "spconv_fod_fused": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "spconv_fod": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "spconv_fod_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    fn = getattr(build.load("spconv"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(features, inv, weights):
    if features.dim() != 2 or inv.dim() != 2 or weights.dim() != 3:
        raise ValueError(
            f"expected features (N, Cin), inv (K, M), weights (K, Cin, Cout); "
            f"got {tuple(features.shape)}, {tuple(inv.shape)}, "
            f"{tuple(weights.shape)}")
    k, m = inv.shape
    if weights.shape[:2] != (k, features.shape[1]):
        raise ValueError(
            f"weights {tuple(weights.shape)} do not match K={k}, "
            f"Cin={features.shape[1]}")
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("features and weights must be float32")
    if inv.dtype != torch.int32:
        raise TypeError(f"inv must be int32, got {inv.dtype}")


def _kernel_device(features: torch.Tensor) -> torch.device:
    if features.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{features.device}")
    return features.device


def _device_operand(t: torch.Tensor, what: str, device, shape=None,
                    dtype=torch.float32) -> int:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def spconv_fod_cuda(features: torch.Tensor, inv: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """features (N, Cin) f32, inv (K, M) int32 (-1 = none), weights
    (K, Cin, Cout) f32 -> (M, Cout) f32."""
    _check(features, inv, weights)
    if features.device.type == "cpu":
        return spconv_fod_ref(features, inv, weights)
    dev = _kernel_device(features)
    (n, cin), (k, m), cout = features.shape, inv.shape, weights.shape[2]
    ptrs = [_device_operand(features, "features", dev),
            _device_operand(inv, "inv", dev, dtype=torch.int32),
            _device_operand(weights, "weights", dev)]
    out = torch.empty((m, cout), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    err = _fn("spconv_fod")(*ptrs, out.data_ptr(), n, cin, k, m, cout,
                            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "spconv_fod")
    LAUNCHES["spconv_fod"] += 1
    return out


def spconv_fod_fused_cuda(features: torch.Tensor, inv: torch.Tensor,
                          weights: torch.Tensor,
                          epilogue: Epilogue | None = None) -> torch.Tensor:
    """`spconv_fod_cuda` with `epilogue` (bias -> layernorm -> +residual ->
    ReLU -> *mask) applied in the kernel's flush.  Cout <= 256."""
    _check(features, inv, weights)
    epi = epilogue or Epilogue()
    if (epi.ln_scale is None) != (epi.ln_bias is None):
        raise ValueError("Epilogue.ln_scale and ln_bias must come together")
    if features.device.type == "cpu":
        return spconv_fod_fused_ref(features, inv, weights, epilogue)
    dev = _kernel_device(features)
    (n, cin), (k, m), cout = features.shape, inv.shape, weights.shape[2]
    if cout > MAX_FUSED_COUT:
        raise ValueError(f"fused kernel takes Cout <= {MAX_FUSED_COUT}, got "
                         f"{cout}")
    ptrs = [_device_operand(features, "features", dev),
            _device_operand(inv, "inv", dev, dtype=torch.int32),
            _device_operand(weights, "weights", dev)]
    for t, what, shape in ((epi.bias, "bias", (cout,)),
                           (epi.ln_scale, "ln_scale", (cout,)),
                           (epi.ln_bias, "ln_bias", (cout,)),
                           (epi.residual, "residual", (m, cout)),
                           (epi.mask, "mask", (m,))):
        ptrs.append(None if t is None
                    else _device_operand(t, what, dev, shape))
    out = torch.empty((m, cout), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    err = _fn("spconv_fod_fused")(
        *ptrs, out.data_ptr(), n, cin, k, m, cout, int(bool(epi.relu)),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "spconv_fod_fused")
    LAUNCHES["spconv_fod_fused"] += 1
    return out
