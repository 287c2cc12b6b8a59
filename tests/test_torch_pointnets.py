"""Port parity, end to end, of the PointNet family: PointNet, PointNet++
(c), (s) and (ps), DGCNN and F-PointNet++ at reduced sizes (B = 2 clouds
of 96 points, the second partly masked; n1 = 32, n2 = 8; DGCNN k = 8),
with the reference's weights carried across by `load_jax_params`, against
the reference under `jax.jit` (its `nn.mlp_chain` in XLA).

Logits (and F-PointNet++'s centre and box): atol = rtol = 1e-4, float32
sums in another order.  Argmax labels must be equal on valid points.  On
the CPU every chain takes the plain version: no kernel launch is counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import dense_xyz_batch
from repro.models import pointnets as PN
from repro_torch.kernels.fused_mlp import fused_mlp as K
from repro_torch.models import pointnets as TPN
from repro_torch.models.params import flatten_tree, load_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)

# name: (init name, init kwargs, apply kwargs, per-point output)
MODELS = {
    "pointnet": ("pointnet", {"n_classes": 40}, {}, False),
    "pointnet++(c)": ("pointnetpp_cls", {"n_classes": 40},
                      {"n1": 32, "n2": 8}, False),
    "pointnet++(s)": ("pointnetpp_seg", {"n_classes": 13},
                      {"n1": 32, "n2": 8}, True),
    "pointnet++(ps)": ("pointnetpp_seg", {"n_classes": 50},
                       {"n1": 32, "n2": 8}, True),
    "dgcnn": ("dgcnn", {"n_classes": 16}, {"k": 8}, False),
    "f-pointnet++": ("fpointnetpp", {}, {}, True),
}


@pytest.fixture(scope="module")
def cloud():
    xyz, mask, _ = dense_xyz_batch(0, 0, 2, 96)
    mask[1, 70:] = False
    return xyz, mask


def reference(name, xyz, mask, seed=0):
    init, init_kw, apply_kw, _ = MODELS[name]
    params = jax.jit(lambda k: getattr(PN, f"{init}_init")(k, **init_kw))(
        jax.random.key(seed))
    apply = getattr(PN, f"{init}_apply")
    out = jax.jit(lambda p, x, m: apply(p, x, m, **apply_kw))(
        params, jnp.asarray(xyz), jnp.asarray(mask))
    return params, jax.tree_util.tree_map(np.asarray, out)


def port_module(name, params):
    init, init_kw, _, _ = MODELS[name]
    module = getattr(TPN, f"{init}_init")(torch.Generator().manual_seed(0),
                                          **init_kw, device="cpu")
    return load_jax_params(module, jax.tree_util.tree_map(np.array, params))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_reference(cloud, name):
    xyz, mask = cloud
    params, want = reference(name, xyz, mask)
    module = port_module(name, params)
    K.reset_launch_counts()
    got = module(torch.from_numpy(xyz), torch.from_numpy(mask),
                 **MODELS[name][2])
    assert set(K.LAUNCHES.values()) == {0}          # CPU: the plain version
    per_point = MODELS[name][3]
    if name == "f-pointnet++":
        for key in ("center", "box"):
            np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)
        got, want = got["seg"], want["seg"]
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    valid = mask if per_point else np.ones(got.shape[0], bool)
    np.testing.assert_array_equal(got.argmax(-1)[valid],
                                  want.argmax(-1)[valid])


@pytest.mark.parametrize("name", list(MODELS))
def test_init_keys_shapes_and_distributions_match_reference(name):
    init, init_kw, _, _ = MODELS[name]
    ref = jax.eval_shape(lambda: getattr(PN, f"{init}_init")(
        jax.random.key(0), **init_kw))
    module = getattr(TPN, f"{init}_init")(torch.Generator().manual_seed(0),
                                          **init_kw, device="cpu")
    flat = dict(flatten_tree(ref))
    state = module.state_dict()
    assert set(state) == set(flat)
    for key, t in state.items():
        assert tuple(t.shape) == tuple(flat[key].shape), key
        if key.endswith(".w"):
            assert 0 < float(t.abs().max()) <= 1 / np.sqrt(t.shape[0]), key
        else:
            assert bool((t == 0).all()), key
    again = getattr(TPN, f"{init}_init")(torch.Generator().manual_seed(0),
                                         **init_kw, device="cpu")
    assert all(torch.equal(state[k], v)
               for k, v in again.state_dict().items())


def test_masked_max_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    mask = rng.random((2, 5, 4)) > 0.5
    mask[0, 0] = False                        # an all-invalid group -> 0
    want = PN.masked_max(jnp.asarray(x), jnp.asarray(mask), axis=2)
    got = TPN.masked_max(torch.from_numpy(x), torch.from_numpy(mask), axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TPN.pointnet_init(torch.Generator().manual_seed(0))
