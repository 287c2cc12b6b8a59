"""Assigned input-shape sets of the architecture pool — the jax-free part
of the reference's `launch/shapes.py` (`ShapeSpec`, `SHAPES`, the [vlm] /
[audio] constants and `cell_supported`).

The reference's `input_specs` / `decode_state_specs` build the dry-run's
abstract inputs; they come with the dry-run (`launch/dryrun.py`), the
next slice of ROADMAP.md Queue A item 6.  The mesh is `launch/mesh.py`.

Skip rules (per assignment):
  * long_500k needs sub-quadratic attention -> only archs with
    cfg.subquadratic (gemma2 local/global, jamba, xlstm, mixtral SWA);
    skipped with a note for pure full-attention archs.
  * point-cloud archs have no LM shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig


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
