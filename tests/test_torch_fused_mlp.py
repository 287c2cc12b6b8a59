"""Port parity of temporal layer fusion: the planner (`core.fusion`) and
the fused-MLP ops, against the reference's planner and its Pallas kernel in
interpret mode.

Fusion groups and DRAM byte counts must be equal.  Floats: the reference's
own `_tol` (tests/test_kernels.py): atol = rtol = 1e-4 in float32 and
2e-2 in bfloat16 (one bf16 rounding of sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as RN
from repro.core import fusion as RF
from repro.kernels.fused_mlp import ops as RO
from repro_torch import nn as TN
from repro_torch.core import fusion as TF
from repro_torch.kernels.fused_mlp import fused_mlp as K
from repro_torch.kernels.fused_mlp import ops as TO

CHAINS = {  # the PointNet family's MLP chains at width 1
    "pp_seg.sa1": [3, 32, 32, 64], "pp_seg.sa2": [67, 64, 64, 128],
    "pp_seg.fp2": [192, 128, 64], "pp_seg.fp1": [64, 64, 64],
    "pp_seg.head": [64, 64, 13], "pointnet.feat": [3, 64, 64, 64, 128, 1024],
    "pointnet.head": [1024, 512, 256, 40], "pp_cls.sa3": [259, 256, 512, 1024],
    "dgcnn.ec1": [6, 64], "dgcnn.agg": [256, 1024],
    "fpointnet.box": [67, 256, 7],
}
BUDGETS = [None, 1 << 20, 64 * 1024 * 1024, 50_000]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def chain_arrays(rng, widths):
    ws = [rng.normal(size=(a, b)) / np.sqrt(a)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [rng.normal(size=(b,)) * 0.1 for b in widths[1:]]
    return ws, bs


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_plan_fusion_matches_reference(name, budget):
    widths = CHAINS[name]
    kw = {} if budget is None else {"budget_bytes": budget}
    want = RF.plan_fusion(widths, budget or TF.DEFAULT_ONCHIP_BUDGET_BYTES)
    got = TF.plan_fusion(widths, **kw)
    assert [tuple(vars(g).values()) for g in got] == \
        [tuple(vars(g).values()) for g in want]
    for dtype_bytes in (2, 4):
        assert TF.plan_fusion(widths, 50_000, dtype_bytes) == [
            TF.FusionGroup(**vars(g))
            for g in RF.plan_fusion(widths, 50_000, dtype_bytes)]
    n = 1000
    assert TF.dram_bytes_unfused(n, widths) == \
        RF.dram_bytes_unfused(n, widths)
    assert TF.dram_bytes_fused(n, widths, got) == \
        RF.dram_bytes_fused(n, widths, want)


def test_planner_default_budget_is_the_cards_shared_memory():
    assert TF.DEFAULT_ONCHIP_BUDGET_BYTES == 232448
    assert TF.CANDIDATE_TILES == RF.CANDIDATE_TILES
    # a single layer that overflows is emitted alone at the smallest tile
    groups = TF.plan_fusion([1024, 512, 256, 40])
    assert groups[0] == TF.FusionGroup(0, 1, 128, 2883584)
    # PointNet++(s): 1 + 1 + 2 + 1 + 1 groups at the card's budget
    counts = [len(TF.plan_fusion(CHAINS[f"pp_seg.{c}"]))
              for c in ("sa1", "sa2", "fp2", "fp1", "head")]
    assert counts == [1, 1, 2, 1, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths,final_act", [([3, 32, 32, 64], True),
                                              ([67, 64, 13], False),
                                              ([6, 64], True)])
def test_fused_mlp_matches_reference_pallas(widths, final_act, dtype):
    rng = np.random.default_rng(sum(widths))
    x = rng.normal(size=(100, widths[0]))
    ws, bs = chain_arrays(rng, widths)
    jdt = getattr(jnp, dtype)
    want = RO.fused_mlp(jnp.asarray(x, jdt), [jnp.asarray(w, jdt) for w in ws],
                        [jnp.asarray(b, jdt) for b in bs], tile_points=64,
                        final_act=final_act)
    tdt = getattr(torch, dtype)

    def tt(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(tdt)

    before = dict(K.LAUNCHES)
    got = TO.fused_mlp(tt(x), [tt(w) for w in ws], [tt(b) for b in bs],
                       final_act=final_act)
    assert got.dtype == tdt and got.shape == (100, widths[-1])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert K.LAUNCHES == before               # CPU: the plain version


@pytest.mark.parametrize("widths,n_groups", [([12, 48, 48, 24], 1),
                                             ([1024, 512, 256, 40], 3)])
@pytest.mark.parametrize("final_act", [True, False])
def test_fused_mlp_chain_matches_reference_and_mlp_chain(widths, n_groups,
                                                         final_act):
    # at the card's budget the second chain splits into three groups
    assert len(TF.plan_fusion(widths)) == n_groups
    ref_p = RN.mlp_chain_init(jax.random.key(0), widths)
    port_p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = np.random.default_rng(4).normal(size=(20, widths[0])) \
        .astype(np.float32)
    want = RO.fused_mlp_chain(
        jnp.asarray(x), ref_p, final_act=final_act,
        budget_bytes=TF.DEFAULT_ONCHIP_BUDGET_BYTES)
    got = TO.fused_mlp_chain(torch.from_numpy(x), port_p,
                             final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    plain = TN.mlp_chain(port_p, torch.from_numpy(x), final_act=final_act)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(RN.mlp_chain(ref_p, jnp.asarray(x),
                                               final_act=final_act)),
        rtol=1e-4, atol=1e-4)


def test_chain_without_bias_uses_zeros():
    rng = np.random.default_rng(5)
    p = {"fc0": {"w": torch.from_numpy(rng.normal(size=(5, 7))
                                       .astype(np.float32))}}
    x = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))
    torch.testing.assert_close(TO.fused_mlp_chain(x, p),
                               torch.relu(x @ p["fc0"]["w"]))


def test_row_tile_and_operand_checks():
    # buffers of the widest layer decide the tile; small grids halve it
    assert K.row_tile([3, 32, 32, 64], 131072) == 64
    assert K.row_tile([1024, 512], 8192) == 32
    assert K.row_tile([1024, 512], 16) == 16
    assert K.row_tile([1024, 512, 256, 40], 8192) == 32
    assert K.smem_bytes([1024, 512, 256, 40], 32) == 4 * (32 * 128
                                                          + 32 * 1536)
    # single-layer groups with few row tiles split their columns
    assert K.col_splits([1024, 512], 8, 16) == 4
    assert K.col_splits([1024, 512, 256], 8, 16) == 1
    assert K.col_splits([128, 1024], 8192, 32) == 1
    assert K.col_splits([256, 1024], 2000, 32) == 3
    with pytest.raises(ValueError, match="shared memory"):
        K.row_tile([8000, 8000, 8], 100)
    x = torch.zeros(4, 3)
    w, b = torch.zeros(3, 5), torch.zeros(5)
    with pytest.raises(ValueError, match="chain"):
        K.fused_mlp_cuda(x, [torch.zeros(4, 5)], [b])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.fused_mlp_cuda(x.double(), [w.double()], [b.double()])
    with pytest.raises(TypeError, match="weights and bias"):
        K.fused_mlp_cuda(x, [w.bfloat16()], [b])
    with pytest.raises(ValueError, match="layers"):
        K.fused_mlp_cuda(x, [w], [])
