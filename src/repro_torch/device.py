"""Device policy: entry points run on the card unless the caller asks for
the CPU.  There is no quiet fallback: `device=None` with no GPU raises."""

from __future__ import annotations

import torch


def configure_precision() -> None:
    """Full float32 everywhere.  The reference accumulates in f32
    (`preferred_element_type=jnp.float32`), so TF32 is off for matrix
    products and convolutions alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """`None` -> the first CUDA device; raises when there is none.  Pass
    `device="cpu"` to run the plain PyTorch versions on the CPU.  Also
    sets full float32 precision (`configure_precision`)."""
    configure_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device=\"cpu\" to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device=\"cpu\" to run on the CPU")
    return dev
