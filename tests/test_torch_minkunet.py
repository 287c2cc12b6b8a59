"""Port parity, end to end: a reduced MinkUNet (stem 8, enc (8, 16), dec
(16, 8), 1 block per stage, ~140 valid rows) with the reference's weights,
through every port flow, against the reference's `fod` and `pallas_fused`
(its Pallas kernel in interpret mode).

Logits: atol = rtol = 1e-4, the reference's own `TOL`
(tests/test_spconv_fused.py), covering float32 summation order.  Labels
must be equal on valid rows; the level pyramid's integers exactly so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as M
from repro.data.synthetic import lidar_scene
from repro.models import minkunet as MU
from repro_torch.core import mapping as TM
from repro_torch.kernels.spconv import spconv as TK
from repro_torch.models import minkunet as TMU
from repro_torch.models.params import flatten_tree
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
REDUCED = dict(stem=8, enc_planes=(8, 16), dec_planes=(16, 8),
               blocks_per_stage=1)


def port_module(params, **cfg):
    module = TMU.minkunet_init(torch.Generator().manual_seed(0), **cfg)
    return TMU.load_jax_params(module,
                               jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def reduced():
    params = jax.jit(lambda k: MU.minkunet_init(k, **REDUCED))(
        jax.random.key(0))
    coords, mask, feats = lidar_scene(3, 160, grid=12)
    return params, port_module(params, **REDUCED), coords, mask, feats


@pytest.mark.parametrize("ref_flow", ["fod", "pallas_fused"])
def test_reduced_minkunet_matches_reference(reduced, ref_flow):
    params, module, coords, mask, feats = reduced
    pc = M.make_point_cloud(jnp.asarray(coords), jnp.asarray(mask))
    want = np.asarray(jax.jit(lambda p, f: MU.minkunet_apply(
        p, pc, f, flow=ref_flow))(params, jnp.asarray(feats)))
    tpc = TM.make_point_cloud(torch.from_numpy(coords),
                              torch.from_numpy(mask))
    TK.reset_launch_counts()
    for flow in ("fod", "gms", "cuda", "cuda_fused"):
        got = TMU.minkunet_apply(module, tpc, torch.from_numpy(feats),
                                 flow=flow).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=flow)
        np.testing.assert_array_equal(got.argmax(-1)[mask],
                                      want.argmax(-1)[mask], err_msg=flow)
    assert not any(TK.LAUNCHES.values())


def test_level_pyramid_matches_reference(reduced):
    _, _, coords, mask, _ = reduced
    ref = jax.jit(lambda c, m: MU.build_unet_maps(M.PointCloud(c, m, 1), 2))(
        jnp.asarray(coords), jnp.asarray(mask))
    got = TMU.build_unet_maps(TM.make_point_cloud(torch.from_numpy(coords),
                                                  torch.from_numpy(mask)), 2)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["pc"].coords.numpy(),
                                      np.asarray(r["pc"].coords))
        np.testing.assert_array_equal(g["subm"].inv.numpy(),
                                      np.asarray(r["subm"].inv))
        np.testing.assert_array_equal(g["cloud"].perm.numpy(),
                                      np.asarray(r["cloud"].perm))
        assert ("down" in g) == ("down" in r)
        if "down" in g:
            np.testing.assert_array_equal(g["down"].inv.numpy(),
                                          np.asarray(r["down"].inv))
            np.testing.assert_array_equal(g["down"].inv_t.numpy(),
                                          np.asarray(r["down"].inv_t))


@pytest.mark.parametrize("init", ["full", "mini"])
def test_init_shapes_keys_and_distributions_match_reference(init):
    if init == "full":
        ref = jax.eval_shape(lambda: MU.minkunet_init(jax.random.key(0)))
        module = TMU.minkunet_init(torch.Generator().manual_seed(0))
    else:
        ref = jax.eval_shape(lambda: MU.mini_minkunet_init(jax.random.key(0)))
        module = TMU.mini_minkunet_init(torch.Generator().manual_seed(0))
    flat = dict(flatten_tree(ref))
    state = module.state_dict()
    assert set(state) == set(flat)
    for key, leaf in flat.items():
        assert tuple(state[key].shape) == tuple(leaf.shape), key
    if init == "full":
        assert "enc.0.blocks.1.n1.scale" in state
        assert tuple(state["dec.3.blocks.0.conv1"].shape) == (27, 128, 96)
        assert module.n_stages == 4
    for key, t in state.items():
        if key.endswith(("conv1", "conv2", "down", "up")) or key == "stem":
            bound = 1.0 / np.sqrt(t.shape[0] * t.shape[1])
            assert 0 < float(t.abs().max()) <= bound, key
        elif key.endswith("scale"):
            assert bool((t == 1).all()), key
        elif key.endswith(("bias", ".b")):
            assert bool((t == 0).all()), key
    # the same generator seed gives the same weights
    again = TMU.minkunet_init(torch.Generator().manual_seed(0)) \
        if init == "full" else \
        TMU.mini_minkunet_init(torch.Generator().manual_seed(0))
    assert all(torch.equal(state[k], v) for k, v in again.state_dict().items())


def test_load_jax_params_rejects_mismatched_trees():
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: MU.minkunet_init(jax.random.key(1),
                                                **REDUCED)))
    module = TMU.minkunet_init(torch.Generator().manual_seed(1), **REDUCED)
    with pytest.raises(KeyError, match="missing"):
        TMU.load_jax_params(module, {k: v for k, v in params.items()
                                     if k != "head"})
    params["stem"] = params["stem"][:, :2]
    with pytest.raises(ValueError, match="stem"):
        TMU.load_jax_params(module, params)
