"""Port parity of the ranking-based mapping ops (FPS, kNN, ball query,
gathers) and of `dense_xyz_batch`, against the reference under `jax.jit`.

Integers (indices, validity) must be equal; kNN distances agree at
atol = rtol = 1e-4 (float32 distances computed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PointAccSession as RefSession
from repro.core import pointops as RP
from repro.data.synthetic import dense_xyz_batch
from repro_torch.api import PointAccSession
from repro_torch.core import pointops as TP
from repro_torch.data import synthetic as TS

TOL = dict(rtol=1e-4, atol=1e-4)


def clouds(seed, b=2, n=96, n_masked=30):
    """dense_xyz_batch clouds with the last `n_masked` points of the last
    cloud invalid."""
    xyz, mask, _ = dense_xyz_batch(seed, 0, b, n)
    mask[-1, n - n_masked:] = False
    return xyz, mask


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed,step,batch,n", [(0, 0, 2, 96), (7, 3, 3, 50),
                                               (1, 0, 16, 4096)])
def test_dense_xyz_batch_is_bit_equal(seed, step, batch, n):
    for ref, got in zip(dense_xyz_batch(seed, step, batch, n),
                        TS.dense_xyz_batch(seed, step, batch, n)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("n_samples", [1, 24, 66])
def test_fps_indices_equal(n_samples):
    xyz, mask = clouds(1)
    mask[0, :5] = False                       # start is not index 0
    want = jax.jit(RP.farthest_point_sampling, static_argnums=2)(
        jnp.asarray(xyz), jnp.asarray(mask), n_samples)
    got = TP.farthest_point_sampling(t(xyz), t(mask), n_samples)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,n_ref,chunk", [(8, 96, 1024), (8, 96, 16),
                                           (8, 5, 1024), (3, 40, 7)])
def test_knn_indices_and_distances(k, n_ref, chunk):
    xyz, mask = clouds(2, n=96)
    ref_xyz, ref_mask = xyz[:, :n_ref], mask[:, :n_ref].copy()
    ref_mask[0, 1::3] = False                 # masked refs all tie at 1e10
    fn = jax.jit(RP.knn, static_argnames=("k", "chunk"))
    want_idx, want_d = fn(jnp.asarray(xyz), jnp.asarray(mask),
                          jnp.asarray(ref_xyz), jnp.asarray(ref_mask), k=k,
                          chunk=chunk)
    idx, d = TP.knn(t(xyz), t(mask), t(ref_xyz), t(ref_mask), k, chunk=chunk)
    assert idx.dtype == torch.int32 and idx.shape == (2, 96, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), **TOL)


@pytest.mark.parametrize("radius,k", [(0.2, 16), (0.05, 8), (1.0, 40)])
def test_ball_query_idx_and_valid(radius, k):
    xyz, mask = clouds(3)
    q, qm = xyz[:, ::4].copy(), mask[:, ::4]
    q[0, 0] = 5.0                             # no neighbour in the ball
    fn = jax.jit(RP.ball_query, static_argnames=("radius", "k"))
    want_idx, want_valid = fn(jnp.asarray(q), jnp.asarray(qm),
                              jnp.asarray(xyz), jnp.asarray(mask),
                              radius=radius, k=k)
    idx, valid = TP.ball_query(t(q), t(qm), t(xyz), t(mask), radius, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert not bool(valid[0, 0].any()) and bool(valid[0, 1].all())
    assert bool((idx[..., 1:] == idx[..., :1]).any())    # padded slots


def test_gather_points_is_exact():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(3, 20, 5)).astype(np.float32)
    for shape in [(3, 7), (3, 4, 6)]:
        idx = rng.integers(0, 20, size=shape).astype(np.int32)
        want = RP.gather_points(jnp.asarray(pts), jnp.asarray(idx))
        got = TP.gather_points(t(pts), t(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = rng.random((3, 20)) > 0.5
    want = RP.gather_points(jnp.asarray(mask)[..., None], jnp.asarray(idx))
    got = TP.gather_points(t(mask)[..., None], t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_session_mapping_ops_match_reference():
    xyz, mask = clouds(5)
    ref, port = RefSession(), PointAccSession()
    want = jax.jit(ref.fps, static_argnums=2)(jnp.asarray(xyz),
                                              jnp.asarray(mask), 12)
    got = port.fps(t(xyz), t(mask), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, qm = xyz[:, :12], mask[:, :12]
    want = jax.jit(ref.knn, static_argnums=4)(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(xyz), jnp.asarray(mask),
        5)
    got = port.knn(t(q), t(qm), t(xyz), t(mask), 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    want = jax.jit(ref.ball_query, static_argnums=(4, 5))(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(xyz), jnp.asarray(mask),
        0.3, 6)
    got = port.ball_query(t(q), t(qm), t(xyz), t(mask), 0.3, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
