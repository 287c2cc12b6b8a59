"""Assigned input-shape sets of the architecture pool — the port of the
reference's `launch/shapes.py`.

Every (arch x shape) pair is a dry-run "cell".  `input_specs()` returns
the batch of a cell's step as meta tensors (shapes and dtypes, no
memory), the reference's ShapeDtypeStructs, including the stubbed
modality-frontend embeddings for [audio]/[vlm]; `decode_state_specs()`
the decode-state tree the same way.  The dry run (`launch/dryrun.py`)
makes fake tensors of them on its device.  The mesh is `launch/mesh.py`.

Skip rules (per assignment):
  * long_500k needs sub-quadratic attention -> only archs with
    cfg.subquadratic (gemma2 local/global, jamba, xlstm, mixtral SWA);
    skipped with a note for pure full-attention archs.
  * point-cloud archs have no LM shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig

I32 = torch.int32
BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# [vlm]: patch embeddings prepended to the text stream
VLM_PATCH_TOKENS = 1024
# [audio]: decoder length as a fraction of the encoder frame count
AUDIO_DEC_FRACTION = 4


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """None if runnable; else a human-readable skip reason."""
    if cfg.family == "pointcloud":
        return "point-cloud arch: LM shapes n/a (see paper benchmarks)"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: long_500k needs sub-quadratic "
                "attention (skip noted in DESIGN.md)")
    return None


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _positions(cfg: ArchConfig, b: int, s: int):
    if cfg.mrope:
        return _spec((b, s, 3), I32)
    return _spec((b, s), I32)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The batch of this cell's step as meta tensors: int32 ids and
    positions ((B, S, 3) under M-RoPE), bf16 frontend embeddings; [audio]
    decodes max(128, S // 4) tokens over S frames, [vlm] prepends
    min(1024, S // 4) patch embeddings to S minus those text tokens."""
    b, s = shape.batch, shape.seq
    if shape.kind == "decode":
        return {
            "tokens": _spec((b, 1), I32),
            "positions": _positions(cfg, b, 1),
            "cache_pos": _spec((b,), I32),
        }

    if cfg.family == "audio":
        s_dec = max(128, s // AUDIO_DEC_FRACTION)
        batch = {
            "frame_embeds": _spec((b, s, cfg.d_model), BF16),
            "enc_positions": _spec((b, s), I32),
            "tokens": _spec((b, s_dec), I32),
            "positions": _spec((b, s_dec), I32),
        }
        if shape.kind == "train":
            batch["labels"] = _spec((b, s_dec), I32)
        return batch

    if cfg.family == "vlm":
        s_img = min(VLM_PATCH_TOKENS, s // 4)
        batch = {
            "patch_embeds": _spec((b, s_img, cfg.d_model), BF16),
            "tokens": _spec((b, s - s_img), I32),
            "positions": _positions(cfg, b, s),
        }
        if shape.kind == "train":
            batch["labels"] = _spec((b, s), I32)
        return batch

    batch = {
        "tokens": _spec((b, s), I32),
        "positions": _positions(cfg, b, s),
    }
    if shape.kind == "train":
        batch["labels"] = _spec((b, s), I32)
    return batch


def decode_state_specs(model, cfg: ArchConfig, shape: ShapeSpec):
    """The decode-state tree of this cell as meta tensors (the caches in
    bf16; each recurrent state in its own dtype)."""
    del cfg
    return model.init_state(shape.batch, shape.seq, BF16, device="meta")
