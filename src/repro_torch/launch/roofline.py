"""Roofline terms of a dry-run cell on the NVIDIA H100 — the port of the
reference's `launch/roofline.py`, with the card's own figures in place of
the reference's TPU.

Hardware model, by the card's name (NVIDIA H100 data sheet, dense, no
sparsity, at the card's full 700 W (SXM5) / 350 W (PCIe) power limit; a
card set below it runs slower), per GPU:

                  bf16 tensor   TF32 tensor   float32 FMA   HBM
  H100 SXM5       989e12        494.7e12      67e12         3.35e12 B/s
  H100 PCIe       756e12        378e12        51e12         2.0e12 B/s

  network   50e9 B/s: one 400 Gb/s NDR InfiniBand port a GPU.  The
            production meshes' 16-wide axes span two 8-GPU nodes, so a
            collective over them runs at the network's rate;
  NVLink 4  450e9 B/s a direction, inside a node (stated, not used).

Terms per cell, all per GPU:
  compute    = FLOPs       / peak bf16
  memory     = bytes       / HBM rate
  collective = coll bytes  / network rate

The port counts the ops a step dispatches (`launch/dryrun.py`): every
layer is a Python loop trip, so nothing is counted once for many bodies.
It still keeps the reference's two-point depth extrapolation: the step at
depth 1 body and at 2 bodies, per-body cost the delta, and
  total = c(1) + (n_bodies - 1) * (c(2) - c(1)),
which the full-depth run can be held against.  The reference's
`collective_bytes` parses XLA's HLO text and `extract_cost` reads XLA's
`cost_analysis`; the port has no HLO, and its counter takes their place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional


class Hardware(NamedTuple):
    name: str
    peak_flops: float     # dense bf16 tensor FLOP/s
    tf32_flops: float     # dense TF32 tensor FLOP/s
    fma_flops: float      # float32 FLOP/s off the tensor cores
    hbm_bw: float         # B/s
    link_bw: float        # B/s a GPU off its node (the collective term)
    nvlink_bw: float      # B/s a direction inside a node


NETWORK_BW = 50e9        # one 400 Gb/s NDR port a GPU
NVLINK_BW = 450e9        # NVLink 4, a direction

H100 = {
    "sxm": Hardware("H100 SXM5", 989e12, 494.7e12, 67e12, 3.35e12,
                    NETWORK_BW, NVLINK_BW),
    "pcie": Hardware("H100 PCIe", 756e12, 378e12, 51e12, 2.0e12,
                     NETWORK_BW, NVLINK_BW),
}

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")


def hardware(card_name: Optional[str] = None) -> Hardware:
    """The H100's figures for a card name as `torch.cuda.get_device_name`
    gives it: PCIe when the name says so, else SXM5 (also for no name)."""
    return H100["pcie" if card_name and "PCIe" in card_name else "sxm"]


@dataclasses.dataclass
class CellCost:
    """All values are PER GPU: the dry run counts the local ops of one
    rank, and a collective's operand is that rank's shard."""
    flops: float                 # per-GPU counted FLOPs
    hbm_bytes: float             # per-GPU bytes the ops move
    coll_bytes_per_chip: float   # per-GPU collective bytes on the wire
    coll_by_kind: Dict[str, float]

    def terms(self, analytic_flops_per_chip: Optional[float] = None,
              hw: Optional[Hardware] = None) -> Dict[str, float]:
        hw = hw or hardware()
        f = analytic_flops_per_chip if analytic_flops_per_chip else \
            self.flops
        return {
            "compute_s": f / hw.peak_flops,
            "memory_s": self.hbm_bytes / hw.hbm_bw,
            "collective_s": self.coll_bytes_per_chip / hw.link_bw,
        }


def extrapolate(c1: Dict, c2: Dict, coll1: Dict, coll2: Dict,
                n_bodies: int) -> CellCost:
    """Two-point depth extrapolation (see the module docstring); `c1`,
    `c2` hold "flops" and "bytes", `coll1`, `coll2` bytes by kind."""
    flops = c1["flops"] + (n_bodies - 1) * max(
        0.0, c2["flops"] - c1["flops"])
    byts = c1["bytes"] + (n_bodies - 1) * max(
        0.0, c2["bytes"] - c1["bytes"])
    per_kind = {}
    total_coll = 0.0
    for k in COLL_KINDS:
        v = coll1.get(k, 0) + (n_bodies - 1) * max(
            0, coll2.get(k, 0) - coll1.get(k, 0))
        per_kind[k] = float(v)
        total_coll += v
    return CellCost(flops, byts, total_coll, per_kind)


def model_flops(cfg, shape, n_active_params: int,
                total_tokens: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train;
    2*N*D for a forward-only (prefill/decode) step."""
    if total_tokens is None:
        total_tokens = shape.batch * (shape.seq if shape.kind != "decode"
                                      else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active_params * total_tokens
