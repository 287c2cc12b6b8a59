"""MinkowskiUNet-style sparse conv U-Net (the paper's MinkNet benchmark)
plus the Mini-MinkowskiUNet co-design (paper §5.2.2).

Structure: submanifold stem -> N encoder stages (stride-2 down conv +
residual blocks) -> N decoder stages (transposed conv back onto the cached
finer cloud + skip concat + residual blocks) -> linear head.  Every conv
runs through `PointAccSession.conv` / `conv_transposed` with its epilogue
(layernorm -> residual -> ReLU -> row mask) as a `core.sparseconv.Epilogue`,
so `flow="cuda_fused"` folds each into the kernel's flush.

The weights live in `MinkUNet`, a `models.params.ParamTree` whose
`state_dict` keys are the reference's parameter-tree paths joined by "."
(`enc.0.blocks.1.n1.scale`); `load_jax_params` copies a reference tree
(as numpy) into it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch import nn as N
from repro_torch.api import PointAccSession
from repro_torch.core import fusion as FU
from repro_torch.core import mapping as M
from repro_torch.core import sparseconv as SC
from repro_torch.core.tensor import MapContext, SparseTensor
from repro_torch.models.params import ParamTree, load_jax_params  # noqa: F401


class MinkUNet(ParamTree):
    """MinkUNet weights; `forward(session, x)` runs `minkunet_forward`."""

    @property
    def n_stages(self) -> int:
        return len(self.enc._modules)

    def forward(self, session: PointAccSession, x: SparseTensor):
        return minkunet_forward(session, self.tree(), x)


def conv_w_init(gen: torch.Generator, k: int, c_in: int,
                c_out: int) -> torch.Tensor:
    return N.uniform_init(gen, (k, c_in, c_out), 1.0 / math.sqrt(k * c_in))


def _layernorm_init(gen: torch.Generator, d: int):
    return N.layernorm_init(d, gen.device)


def _block_init(gen: torch.Generator, c_in: int, c_out: int):
    p = {"conv1": conv_w_init(gen, 27, c_in, c_out),
         "n1": _layernorm_init(gen, c_out),
         "conv2": conv_w_init(gen, 27, c_out, c_out),
         "n2": _layernorm_init(gen, c_out)}
    if c_in != c_out:
        p["proj"] = N.dense_init(gen, c_in, c_out, use_bias=False)
    return p


def minkunet_init(generator: torch.Generator, c_in: int = 4,
                  n_classes: int = 13, stem: int = 32,
                  enc_planes: Sequence[int] = (32, 64, 128, 256),
                  dec_planes: Sequence[int] = (256, 128, 96, 96),
                  blocks_per_stage: int = 2) -> MinkUNet:
    """Random MinkUNet weights with the reference's shapes and
    distributions (uniform +-1/sqrt(fan_in), layernorm ones/zeros, zero
    head bias), drawn from `generator`, every leaf on its device."""
    g = generator
    params = {"stem": conv_w_init(g, 27, c_in, stem),
              "stem_n": _layernorm_init(g, stem)}
    c = stem
    enc = []
    for planes in enc_planes:
        stage = {"down": conv_w_init(g, 8, c, planes),
                 "down_n": _layernorm_init(g, planes), "blocks": []}
        c = planes
        for _ in range(blocks_per_stage):
            stage["blocks"].append(_block_init(g, c, planes))
        enc.append(stage)
    params["enc"] = enc
    dec = []
    skip_cs = [stem] + list(enc_planes[:-1])
    for i, planes in enumerate(dec_planes):
        stage = {"up": conv_w_init(g, 8, c, planes),
                 "up_n": _layernorm_init(g, planes), "blocks": []}
        cb = planes + skip_cs[-(i + 1)]
        for _ in range(blocks_per_stage):
            stage["blocks"].append(_block_init(g, cb, planes))
            cb = planes
        dec.append(stage)
        c = planes
    params["dec"] = dec
    params["head"] = N.dense_init(g, c, n_classes)
    return MinkUNet(params)


def halo_spec(params):
    """Receptive-field spec of this UNet for the partition planner
    (`repro_torch.partition.halo`): one stem dilation at level 0, two
    submanifold dilations per residual block at every level each stage
    touches (encoder and decoder), with the stride-2 down / transposed
    convs as the level transitions.  `params` is a `MinkUNet` or its
    parameter tree."""
    from repro_torch.partition.halo import HaloSpec
    tree = params.tree() if isinstance(params, ParamTree) else params
    n_stages = len(tree["enc"])
    blocks = len(tree["enc"][0]["blocks"]) if n_stages else 0
    return HaloSpec.uniform(n_stages, blocks)


def mini_minkunet_init(generator: torch.Generator, c_in: int = 4,
                       n_classes: int = 13) -> MinkUNet:
    """The paper's co-designed shallow/narrow MinkowskiUNet (Fig. 16)."""
    return minkunet_init(generator, c_in, n_classes, stem=16,
                         enc_planes=(16, 32), dec_planes=(32, 16),
                         blocks_per_stage=1)


def _norm_epilogue(n_params, mask, residual=None):
    """Epilogue of every trunk conv: layernorm -> (+skip) -> ReLU -> mask."""
    return SC.Epilogue(ln_scale=n_params["scale"], ln_bias=n_params["bias"],
                       relu=True, mask=mask, residual=residual)


def _block_forward(session: PointAccSession, p, x: SparseTensor):
    """One residual block: two submanifold convs with their epilogues."""
    h = session.conv(x, p["conv1"],
                     epilogue=_norm_epilogue(p["n1"], x.mask))
    skip = N.dense(p["proj"], x.feats) if "proj" in p else x.feats
    return session.conv(h, p["conv2"],
                        epilogue=_norm_epilogue(p["n2"], x.mask,
                                                residual=skip))


def minkunet_forward(session: PointAccSession, params,
                     x: SparseTensor) -> torch.Tensor:
    """Forward pass through the session -> (N, n_classes) logits.

    For `flow="cuda_fused"` on a fresh context the cloud is first put into
    packed-key order (reusing the context's sort) and the head output is
    scattered back to the caller's row order.  A context that already
    carries maps (rebuilt from a cached level pyramid) is used as-is.
    """
    if isinstance(params, ParamTree):
        params = params.tree()
    n_stages = len(params["enc"])
    order = None
    if session.config.flow == "cuda_fused" and not x.context.maps:
        x, order = session.canonicalized(x)

    h = session.conv(x, params["stem"],
                     epilogue=_norm_epilogue(params["stem_n"], x.mask))
    skips = [h]
    for stage in params["enc"]:
        out_mask = session.out_cloud(h, 2).mask
        h = session.conv(h, stage["down"], stride=2,
                         epilogue=_norm_epilogue(stage["down_n"], out_mask))
        for b in stage["blocks"]:
            h = _block_forward(session, b, h)
        skips.append(h)

    for i, stage in enumerate(params["dec"]):
        skip = skips[n_stages - 1 - i]          # target (finer) level
        h = session.conv_transposed(
            h, stage["up"], stride=2,
            epilogue=_norm_epilogue(stage["up_n"], skip.mask))
        h = h.with_feats(torch.cat([h.feats, skip.feats], dim=-1))
        for b in stage["blocks"]:
            h = _block_forward(session, b, h)

    out = N.dense(params["head"], h.feats) * h.mask[:, None]
    if order is not None:
        unsorted = torch.zeros_like(out)
        unsorted[order] = out
        out = unsorted
    return out


def build_unet_maps(pc: M.PointCloud, n_stages: int,
                    engine: str | None = None):
    """Mapping pass: per-level dicts with the level's cloud ("pc"), the
    submanifold k=3 maps ("subm"), the stride-2 down maps into the next
    level ("down") and, under the v2 engine, the level's SortedCloud
    ("cloud"; each level is sorted exactly once).  The decoder reuses
    "down" swapped."""
    ctx = MapContext(engine=engine)
    ctx.register_cloud(pc.stride, pc)
    levels = []
    stride = pc.stride
    for i in range(n_stages + 1):
        subm, _ = ctx.conv_maps(3, stride, 1)
        level = {"pc": ctx.point_cloud(stride), "subm": subm}
        if ctx.engine == "v2":
            level["cloud"] = ctx.sorted_cloud(stride)
        if i < n_stages:
            level["down"], _ = ctx.conv_maps(2, stride, 2)
            stride *= 2
        levels.append(level)
    return levels


def _context_from_levels(levels, base_stride: int = 1) -> MapContext:
    """Rebuild a MapContext from a `build_unet_maps` level pyramid (level i
    sits at base_stride * 2^i); a pyramid without SortedClouds was built
    by the v1 engine."""
    engine = "v2" if any("cloud" in lv for lv in levels) else "v1"
    ctx = MapContext(engine=engine)
    stride = base_stride
    for level in levels:
        ctx.clouds[stride] = level.get("cloud", level["pc"])
        ctx.maps[(3, stride, stride)] = level["subm"]
        if "down" in level:
            ctx.maps[(2, stride, 2 * stride)] = level["down"]
        stride *= 2
    return ctx


def minkunet_apply(params, pc: M.PointCloud, feats: torch.Tensor,
                   flow: str = "fod", levels=None) -> torch.Tensor:
    """A session with `flow` + `minkunet_forward`; pass a precomputed
    `levels` pyramid (from a serving cache) to skip map building."""
    session = PointAccSession(flow=flow)
    context = _context_from_levels(levels, pc.stride) \
        if levels is not None else None
    x = session.tensor(pc.coords, pc.mask, feats, stride=pc.stride,
                       context=context)
    return minkunet_forward(session, params, x)


def epilogue_dram_bytes(params, levels, fused: bool) -> int:
    """Fig.-20-style DRAM model for the conv epilogues of one forward pass:
    `core.fusion.dram_bytes_conv_epilogue` summed over every conv site.
    The unfused total counts each conv's pre-activation write + read-back;
    the fused total only the final activation writes (+ residual reads)."""
    if isinstance(params, ParamTree):
        params = params.tree()
    n_stages = len(params["enc"])

    def site(n_out, w, residual=False):
        return FU.dram_bytes_conv_epilogue(n_out, w.shape[2],
                                           residual=residual, fused=fused)

    def block(p, cap):
        return site(cap, p["conv1"]) + site(cap, p["conv2"], residual=True)

    total = site(levels[0]["pc"].capacity, params["stem"])
    for i, stage in enumerate(params["enc"]):
        cap = levels[i + 1]["pc"].capacity
        total += site(cap, stage["down"])
        total += sum(block(b, cap) for b in stage["blocks"])
    for i, stage in enumerate(params["dec"]):
        cap = levels[n_stages - 1 - i]["pc"].capacity
        total += site(cap, stage["up"])
        total += sum(block(b, cap) for b in stage["blocks"])
    return total
