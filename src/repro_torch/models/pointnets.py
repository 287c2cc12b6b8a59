"""PointNet / PointNet++ / DGCNN family (paper Table 1, PointNet++-based).

Dense-batched representation: xyz (B, N, 3) float32, mask (B, N) bool.
Mapping ops (FPS / ball query / kNN) come from `core.pointops`, the
ranking-based mapping unit.  Aggregation is masked max-pooling.  T-Nets
are omitted, as in the reference.

Every MLP chain runs through `kernels.fused_mlp.ops.fused_mlp_chain` on its
rows flattened to (rows, C): one fused-MLP kernel launch per fusion group
on the card (the plain version for CPU tensors).  Where the reference
calls `nn.mlp_chain`, this module calls `_chain`.

`*_init(generator, ..., device=None)` draws the reference's shapes and
distributions from a `torch.Generator` and returns a `ParamTree` module on
`resolve_device(device)`: the card unless the caller passes
`device="cpu"`.  Its `tree()` has the reference's keys, so
`models.params.load_jax_params` carries reference weights across; its
`forward` runs the matching `*_apply`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import nn
from repro_torch.core import pointops as P
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_mlp.ops import fused_mlp_chain
from repro_torch.models.params import ParamTree

_NEG = -1e9


class PointNetModel(ParamTree):
    """Weights of one PointNet-family model; `forward(*args, **kw)` runs
    its `*_apply` on `tree()`."""

    def __init__(self, tree, apply_fn):
        super().__init__(tree)
        self.apply_fn = apply_fn

    def forward(self, *args, **kwargs):
        return self.apply_fn(self.tree(), *args, **kwargs)


def _model(tree, apply_fn, device) -> PointNetModel:
    return PointNetModel(tree, apply_fn).to(resolve_device(device))


def _chain(p, x: torch.Tensor, final_act: bool = True) -> torch.Tensor:
    """An MLP chain over the last axis, through the fused-MLP kernel."""
    rows = x.reshape(-1, x.shape[-1])
    out = fused_mlp_chain(rows, p, final_act=final_act)
    return out.reshape(*x.shape[:-1], out.shape[-1])


# ---------------------------------------------------------------------------
# shared building blocks
# ---------------------------------------------------------------------------

def masked_max(x: torch.Tensor, mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Max-pool ignoring invalid slots; all-invalid groups produce 0."""
    big = torch.where(mask, 0.0, _NEG).to(x.dtype)
    y = (x + big.unsqueeze(-1)).amax(dim=axis)
    any_valid = mask.any(dim=axis)
    return torch.where(any_valid[..., None], y, 0.0)


def set_abstraction_init(gen, c_in: int, mlp: Sequence[int]):
    return {"mlp": nn.mlp_chain_init(gen, [c_in + 3] + list(mlp))}


def set_abstraction(p, xyz, feats, mask, n_out: int, radius: float, k: int):
    """FPS (Max ranking) -> ball query (TopK ranking) -> shared MLP -> max."""
    centers = P.farthest_point_sampling(xyz, mask, n_out)     # (B, M)
    new_xyz = P.gather_points(xyz, centers)
    new_mask = P.gather_points(mask[..., None], centers)[..., 0]
    idx, valid = P.ball_query(new_xyz, new_mask, xyz, mask, radius, k)
    grouped_xyz = P.gather_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped_xyz, P.gather_points(feats, idx)],
                            dim=-1)
    else:
        grouped = grouped_xyz
    g = _chain(p["mlp"], grouped)                             # (B,M,k,C)
    valid = valid & new_mask[:, :, None]
    new_f = masked_max(g, valid, axis=2)
    return new_xyz, new_f * new_mask[..., None], new_mask


def global_abstraction_init(gen, c_in: int, mlp: Sequence[int]):
    return {"mlp": nn.mlp_chain_init(gen, [c_in + 3] + list(mlp))}


def global_abstraction(p, xyz, feats, mask):
    g = torch.cat([xyz, feats], dim=-1)
    g = _chain(p["mlp"], g)
    return masked_max(g, mask, axis=1)                        # (B, C)


def feature_propagation_init(gen, c_in: int, mlp: Sequence[int]):
    return {"mlp": nn.mlp_chain_init(gen, [c_in] + list(mlp))}


def feature_propagation(p, xyz_fine, mask_fine, xyz_coarse, mask_coarse,
                        f_coarse, f_skip):
    """3-NN inverse-distance interpolation (kNN = TopK ranking) + MLP."""
    idx, dist = P.knn(xyz_fine, mask_fine, xyz_coarse, mask_coarse, 3)
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    interp = torch.einsum("bmk,bmkc->bmc", w, P.gather_points(f_coarse, idx))
    f = torch.cat([interp, f_skip], dim=-1) if f_skip is not None \
        else interp
    return _chain(p["mlp"], f) * mask_fine[..., None]


# ---------------------------------------------------------------------------
# PointNet (classification)
# ---------------------------------------------------------------------------

def pointnet_init(generator: torch.Generator, n_classes: int = 40,
                  width: int = 1, device=None) -> PointNetModel:
    w = width
    tree = {
        "feat": nn.mlp_chain_init(generator, [3, 64 * w, 64 * w, 64 * w,
                                              128 * w, 1024 * w]),
        "head": nn.mlp_chain_init(generator, [1024 * w, 512 * w, 256 * w,
                                              n_classes]),
    }
    return _model(tree, pointnet_apply, device)


def pointnet_apply(params, xyz, mask):
    f = _chain(params["feat"], xyz)
    g = masked_max(f, mask, axis=1)
    return _chain(params["head"], g, final_act=False)


# ---------------------------------------------------------------------------
# PointNet++ SSG (classification): the paper's PointNet++(c)
# ---------------------------------------------------------------------------

def pointnetpp_cls_init(generator: torch.Generator, n_classes: int = 40,
                        width: int = 1, device=None) -> PointNetModel:
    g, w = generator, width
    tree = {
        "sa1": set_abstraction_init(g, 0, [64 * w, 64 * w, 128 * w]),
        "sa2": set_abstraction_init(g, 128 * w, [128 * w, 128 * w, 256 * w]),
        "sa3": global_abstraction_init(g, 256 * w,
                                       [256 * w, 512 * w, 1024 * w]),
        "head": nn.mlp_chain_init(g, [1024 * w, 512 * w, 256 * w,
                                      n_classes]),
    }
    return _model(tree, pointnetpp_cls_apply, device)


def pointnetpp_cls_apply(params, xyz, mask, n1=512, n2=128):
    x1, f1, m1 = set_abstraction(params["sa1"], xyz, None, mask, n1, 0.2, 32)
    x2, f2, m2 = set_abstraction(params["sa2"], x1, f1, m1, n2, 0.4, 64)
    g = global_abstraction(params["sa3"], x2, f2, m2)
    return _chain(params["head"], g, final_act=False)


# ---------------------------------------------------------------------------
# PointNet++ segmentation (SSG): the paper's PointNet++(s) / (ps) backbone
# ---------------------------------------------------------------------------

def pointnetpp_seg_init(generator: torch.Generator, n_classes: int = 13,
                        c_in: int = 0, width: int = 1,
                        device=None) -> PointNetModel:
    return _model(_pointnetpp_seg_tree(generator, n_classes, c_in, width),
                  pointnetpp_seg_apply, device)


def _pointnetpp_seg_tree(g, n_classes: int, c_in: int, w: int):
    return {
        "sa1": set_abstraction_init(g, c_in, [32 * w, 32 * w, 64 * w]),
        "sa2": set_abstraction_init(g, 64 * w, [64 * w, 64 * w, 128 * w]),
        "fp2": feature_propagation_init(g, 128 * w + 64 * w,
                                        [128 * w, 64 * w]),
        "fp1": feature_propagation_init(g, 64 * w + c_in, [64 * w, 64 * w]),
        "head": nn.mlp_chain_init(g, [64 * w, 64 * w, n_classes]),
    }


def pointnetpp_seg_apply(params, xyz, mask, feats=None, n1=256, n2=64,
                         return_features: bool = False):
    x1, f1, m1 = set_abstraction(params["sa1"], xyz, feats, mask,
                                 n1, 0.1, 32)
    x2, f2, m2 = set_abstraction(params["sa2"], x1, f1, m1, n2, 0.2, 32)
    u1 = feature_propagation(params["fp2"], x1, m1, x2, m2, f2, f1)
    u0 = feature_propagation(params["fp1"], xyz, mask, x1, m1, u1, feats)
    logits = _chain(params["head"], u0, final_act=False)
    if return_features:
        return logits, u0
    return logits


# ---------------------------------------------------------------------------
# DGCNN: graph-based, kNN on *features* (paper section 2: mapping on features)
# ---------------------------------------------------------------------------

def edgeconv_init(gen, c_in: int, c_out: int):
    return {"mlp": nn.mlp_chain_init(gen, [2 * c_in, c_out])}


def edgeconv(p, feats, mask, k: int):
    idx, _ = P.knn(feats, mask, feats, mask, k)
    nbrs = P.gather_points(feats, idx)                        # (B,N,k,C)
    center = feats[:, :, None, :]
    edge = torch.cat([center.expand_as(nbrs), nbrs - center], dim=-1)
    e = _chain(p["mlp"], edge)
    valid = mask[:, :, None] & P.gather_points(mask[..., None], idx)[..., 0]
    return masked_max(e, valid, axis=2) * mask[..., None]


def dgcnn_init(generator: torch.Generator, n_classes: int = 16,
               width: int = 1, device=None) -> PointNetModel:
    g, w = generator, width
    tree = {
        "ec1": edgeconv_init(g, 3, 64 * w),
        "ec2": edgeconv_init(g, 64 * w, 64 * w),
        "ec3": edgeconv_init(g, 64 * w, 128 * w),
        "agg": nn.mlp_chain_init(g, [(64 + 64 + 128) * w, 1024 * w]),
        "head": nn.mlp_chain_init(g, [1024 * w, 256 * w, n_classes]),
    }
    return _model(tree, dgcnn_apply, device)


def dgcnn_apply(params, xyz, mask, k: int = 20):
    f1 = edgeconv(params["ec1"], xyz, mask, k)
    f2 = edgeconv(params["ec2"], f1, mask, k)
    f3 = edgeconv(params["ec3"], f2, mask, k)
    f = torch.cat([f1, f2, f3], dim=-1)
    f = _chain(params["agg"], f)
    g = masked_max(f, mask, axis=1)
    return _chain(params["head"], g, final_act=False)


# ---------------------------------------------------------------------------
# F-PointNet++ (detection): instance seg + centre/box regression heads
# ---------------------------------------------------------------------------

def fpointnetpp_init(generator: torch.Generator, n_box_params: int = 7,
                     width: int = 1, device=None) -> PointNetModel:
    g, w = generator, width
    tree = {
        "seg": _pointnetpp_seg_tree(g, 2, 0, w),
        "center": nn.mlp_chain_init(g, [64 * w + 3, 128 * w, 3]),
        "box": nn.mlp_chain_init(g, [64 * w + 3, 256 * w, n_box_params]),
    }
    return _model(tree, fpointnetpp_apply, device)


def fpointnetpp_apply(params, xyz, mask):
    """Frustum pipeline: instance seg -> foreground-weighted pooling ->
    centre + box regression (the paper's detection benchmark structure)."""
    seg_logits, feats = pointnetpp_seg_apply(params["seg"], xyz, mask,
                                             return_features=True)
    fg = torch.softmax(seg_logits, -1)[..., 1:2] * mask[..., None]
    denom = fg.sum(1) + 1e-6
    pooled_f = (fg * feats).sum(1) / denom                    # (B, 64w)
    centroid = (fg * xyz).sum(1) / denom                      # (B, 3)
    h = torch.cat([pooled_f, centroid], dim=-1)
    center = centroid + _chain(params["center"], h, final_act=False)
    box = _chain(params["box"], h, final_act=False)
    return {"seg": seg_logits, "center": center, "box": box}
