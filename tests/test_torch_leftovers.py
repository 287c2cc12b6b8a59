"""Port parity for the main path's planning functions and one-call
helpers: `window_schedule`, `plan_conv_epilogue`,
`dram_bytes_conv_epilogue` and `epilogue_dram_bytes` give integers equal
to the reference's; `sparse_conv` and `from_point_cloud` agree with it
at atol = rtol = 1e-5 (float32 summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as FU
from repro.core import mapping as M
from repro.core import sparseconv as SC
from repro.core import tensor as T
from repro.data.synthetic import lidar_scene
from repro.kernels.spconv import ops as SO
from repro.models import minkunet as MU
from repro_torch.core import fusion as TFU
from repro_torch.core import mapping as TM
from repro_torch.core import sparseconv as TSC
from repro_torch.core import tensor as TT
from repro_torch.kernels.spconv import ops as TSO
from repro_torch.models import minkunet as TMU

TOL = dict(rtol=1e-5, atol=1e-5)
REF_BUDGET = FU.DEFAULT_ONCHIP_BUDGET_BYTES      # the reference's budget


def _clouds(seed=3, n=160, grid=12):
    coords, mask, feats = lidar_scene(seed, n, grid=grid)
    pc = M.make_point_cloud(jnp.asarray(coords), jnp.asarray(mask))
    tpc = TM.make_point_cloud(torch.from_numpy(coords),
                              torch.from_numpy(mask))
    return pc, tpc, feats


def _inv_tables():
    """Inverse tables of a real scene's subm / down maps, and a random one
    with empty tiles and rows past every window."""
    _, tpc, _ = _clouds()
    sub, _ = TM.build_conv_maps(tpc, 3, 1)
    down, _ = TM.build_conv_maps(tpc, 2, 2)
    rng = np.random.default_rng(0)
    rand = rng.integers(-1, 256, size=(8, 256)).astype(np.int32)
    rand[:, 64:128] = -1
    return {"subm": sub.inv.numpy(), "down": down.inv.numpy(),
            "random": rand}


@pytest.mark.parametrize("table", ["subm", "down", "random"])
@pytest.mark.parametrize("out_tile,feat_tile", [(32, 8), (32, 32),
                                                (16, 64), (160, 16)])
def test_window_schedule_integers_equal_reference(table, out_tile,
                                                  feat_tile):
    inv = _inv_tables()[table]
    m = inv.shape[1] // out_tile * out_tile
    inv = np.ascontiguousarray(inv[:, :m])
    n_rows = int(max(inv.max() + 1, feat_tile)) // feat_tile * feat_tile \
        + feat_tile
    want_map, want_n = SO.window_schedule(jnp.asarray(inv), n_rows,
                                          out_tile, feat_tile)
    got_map, got_n = TSO.window_schedule(torch.from_numpy(inv), n_rows,
                                         out_tile, feat_tile)
    assert got_map.dtype == got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


# conv sites of the full-width MinkUNet at the 65536 bucket, plus shapes
# that overflow a small budget (streamed window, then no fusion at all)
SITES = [(65536, 4, 32, 27), (65536, 32, 32, 27), (32768, 32, 64, 8),
         (4096, 256, 256, 27), (65536, 352, 96, 27), (100, 3, 5, 27),
         (7, 64, 64, 8)]


@pytest.mark.parametrize("budget", [REF_BUDGET,
                                    TFU.DEFAULT_ONCHIP_BUDGET_BYTES,
                                    300_000, 20_000])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("site", SITES)
def test_plan_conv_epilogue_equals_reference(site, residual, budget):
    n_in, cin, cout, k = site
    want = FU.plan_conv_epilogue(n_in, cin, cout, k, residual=residual,
                                 budget_bytes=budget)
    got = TFU.plan_conv_epilogue(n_in, cin, cout, k, residual=residual,
                                 budget_bytes=budget)
    assert (got.fuse, got.feat_tile, got.out_tile, got.onchip_bytes) == \
        (want.fuse, want.feat_tile, want.out_tile, want.onchip_bytes)
    assert TFU.CONV_FEAT_TILES == FU.CONV_FEAT_TILES
    for fused in (False, True):
        assert TFU.dram_bytes_conv_epilogue(
            n_in, cout, residual=residual, fused=fused) == \
            FU.dram_bytes_conv_epilogue(n_in, cout, residual=residual,
                                        fused=fused)


def test_map_context_plan_is_memoised_at_the_port_budget():
    ctx = TT.MapContext()
    plan = ctx.plan(65536, 32, 32, 27, residual=True)
    assert ctx.plan(65536, 32, 32, 27, residual=True) is plan
    assert plan == TFU.plan_conv_epilogue(
        65536, 32, 32, 27, residual=True,
        budget_bytes=TFU.DEFAULT_ONCHIP_BUDGET_BYTES)
    ref = T.MapContext().plan(65536, 32, 32, 27, residual=True,
                              budget_bytes=REF_BUDGET)
    got = ctx.plan(65536, 32, 32, 27, residual=True, budget_bytes=REF_BUDGET)
    assert (got.fuse, got.feat_tile, got.onchip_bytes) == \
        (ref.fuse, ref.feat_tile, ref.onchip_bytes)
    assert len(ctx.plans) == 2


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", ["mini", "reduced"])
def test_epilogue_dram_bytes_equals_reference(cfg, fused):
    kw = {} if cfg == "mini" else dict(stem=8, enc_planes=(8, 16, 32),
                                       dec_planes=(32, 16, 8))
    init = MU.mini_minkunet_init if cfg == "mini" else MU.minkunet_init
    tinit = TMU.mini_minkunet_init if cfg == "mini" else TMU.minkunet_init
    params = jax.eval_shape(lambda k: init(k, **kw), jax.random.key(0))
    module = tinit(torch.Generator().manual_seed(0), **kw)
    n_stages = len(params["enc"])
    pc, tpc, _ = _clouds()
    levels = jax.jit(lambda c, m: MU.build_unet_maps(
        M.PointCloud(c, m, 1), n_stages))(pc.coords, pc.mask)
    want = MU.epilogue_dram_bytes(params, levels, fused)
    got = TMU.epilogue_dram_bytes(module, TMU.build_unet_maps(tpc, n_stages),
                                  fused)
    assert got == want and isinstance(got, int)


@pytest.mark.parametrize("flow", ["fod", "cuda_fused"])
@pytest.mark.parametrize("ks,stride", [(3, 1), (2, 2)])
def test_sparse_conv_one_call_matches_reference(flow, ks, stride):
    pc, tpc, feats = _clouds()
    w = np.random.default_rng(1).normal(
        size=(ks ** 3, feats.shape[1], 8)).astype(np.float32)
    want = jax.jit(lambda f, w: SC.sparse_conv(pc, f, w, ks, stride=stride))(
        jnp.asarray(feats), jnp.asarray(w))
    sc = TM.sort_cloud(tpc)
    for cache in (None, sc):
        got = TSC.sparse_conv(tpc, torch.from_numpy(feats),
                              torch.from_numpy(w), ks, stride=stride,
                              flow=flow, cache=cache)
        assert isinstance(got, TSC.SparseConvResult)
        np.testing.assert_allclose(got.features.numpy(),
                                   np.asarray(want.features), **TOL)
        np.testing.assert_array_equal(got.pc.coords.numpy(),
                                      np.asarray(want.pc.coords))
        np.testing.assert_array_equal(got.pc.mask.numpy(),
                                      np.asarray(want.pc.mask))
        np.testing.assert_array_equal(got.maps.inv.numpy(),
                                      np.asarray(want.maps.inv))
    v1 = TSC.sparse_conv(tpc, torch.from_numpy(feats), torch.from_numpy(w),
                         ks, stride=stride, flow=flow, engine="v1")
    assert v1.maps.inv is None
    np.testing.assert_allclose(v1.features.numpy(),
                               np.asarray(want.features), **TOL)
    np.testing.assert_array_equal(v1.pc.coords.numpy(),
                                  np.asarray(want.pc.coords))


def test_from_point_cloud_matches_reference():
    from repro.api import PointAccSession
    from repro_torch.api import PointAccSession as TSession

    pc, tpc, feats = _clouds(4, 120)
    w = np.random.default_rng(2).normal(size=(27, 4, 6)).astype(np.float32)
    x = T.from_point_cloud(pc, jnp.asarray(feats))
    tx = TT.from_point_cloud(tpc, torch.from_numpy(feats))
    assert (tx.stride, tx.capacity) == (x.stride, x.capacity)
    assert 1 in tx.context.clouds
    want = jax.jit(lambda f, w: PointAccSession().conv(
        T.from_point_cloud(pc, f), w).feats)(jnp.asarray(feats),
                                             jnp.asarray(w))
    got = TSession().conv(tx, torch.from_numpy(w))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want), **TOL)
    ctx = TT.MapContext()
    assert TT.from_point_cloud(tpc, torch.from_numpy(feats),
                               context=ctx).context is ctx
