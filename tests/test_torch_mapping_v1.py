"""Port parity for the v1 mapping engine (lexicographic sorts of the int32
coordinate columns) and every point-cloud entry point that takes it.

Integers are compared exactly: `quantize_coords`, `unique_coords`,
`downsample` and `kernel_map` must give the reference's arrays bit for bit
(the same slot for every match, not only the same sets), on clouds with
negative coordinates, coordinates past +-32768, batch indices past 16383
and two spatial dimensions.  The port's own v1 maps must equal its v2 maps
up to per-offset order.  Through the session, the serving engine and the
scheduler a v1 engine must give the reference's v1 labels, also on scenes
outside the packed-key budget that a v2 engine refuses.  The point-cloud
configs and `point_cloud_batch` must equal the reference's.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as M
from repro.core import packed as PK
from repro.data import synthetic as S
from repro.kernels.spconv import ops as spops
from repro_torch.api import PointAccSession
from repro_torch.core import mapping as TM
from repro_torch.core import sparseconv as TSC
from repro_torch.data import synthetic as TS
from repro_torch.kernels.spconv import ops as tspops
from tests.test_mapping import random_cloud
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit, reference_tree

LADDER = (64, 256)
TOL = dict(rtol=1e-5, atol=1e-5)


def both(coords, mask, stride=1):
    ref = M.make_point_cloud(jnp.asarray(coords), jnp.asarray(mask), stride)
    port = TM.make_point_cloud(torch.from_numpy(coords),
                               torch.from_numpy(mask), stride)
    return ref, port


def edge_cloud(kind: str, seed: int = 0, n: int = 70, cap: int = 90):
    """A masked, shuffled cloud of neighbours, moved where v2 cannot go:
    'neg' (negative coords), 'far' (past +32767 and -32768), 'batch'
    (batch index past 16383), 'd2' (two spatial dims), 'dup' (duplicate
    rows, for unique_coords)."""
    rng = np.random.default_rng(seed)
    d = 2 if kind == "d2" else 3
    coords, mask = random_cloud(rng, n, cap, grid=7, d=d)
    v = mask.nonzero()[0]
    if kind == "neg":
        coords[v, 1:] -= 5
    elif kind == "far":
        coords[v[::2], 1] += 40000
        coords[v[1::2], 2] -= 40000
    elif kind == "batch":
        coords[v, 0] += PK.BATCH_MAX + 3000
    elif kind == "dup":
        coords[v[: n // 3]] = coords[v[n // 3: 2 * (n // 3)]]
        coords[v[::5], 1:] -= 3
    return coords, mask


KINDS = ["neg", "far", "batch", "d2", "dup"]


def eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_quantize_coords_equal_reference(stride):
    rng = np.random.default_rng(stride)
    coords = rng.integers(-70000, 70000, size=(200, 4)).astype(np.int32)
    coords[:3] = [[0, -1, -2, -3], [5, 2**31 - 1, -2**31, 7], [1, -8, 8, -9]]
    want = jit(M.quantize_coords, static_argnums=1)(
        jnp.asarray(coords), stride)
    eq(TM.quantize_coords(torch.from_numpy(coords), stride), want)
    with pytest.raises(ValueError, match="power of two"):
        TM.quantize_coords(torch.from_numpy(coords), 3)


# the reference's builds, one jitted function each, so that clouds of one
# shape share a compile
@functools.lru_cache(maxsize=None)
def _ref_downsample(factor):
    return jit(lambda c, m: M.downsample(M.PointCloud(c, m, 1), factor))


@functools.lru_cache(maxsize=None)
def _ref_conv_maps(ks, stride):
    return jit(lambda c, m: M.build_conv_maps(M.PointCloud(c, m, 1), ks,
                                              stride, engine="v1"))


@functools.lru_cache(maxsize=None)
def _ref_invert_maps(capacity):
    return jit(lambda maps: spops.invert_maps(maps, capacity))


@pytest.mark.parametrize("kind", KINDS)
def test_unique_and_downsample_equal_reference(kind):
    coords, mask = edge_cloud(kind, seed=1)
    ref_pc, pc = both(coords, mask)
    w_c, w_m = jit(M.unique_coords)(ref_pc.coords, ref_pc.mask)
    g_c, g_m = TM.unique_coords(pc.coords, pc.mask)
    eq(g_c, w_c)
    eq(g_m, w_m)
    for factor in (2, 4):
        want = _ref_downsample(factor)(ref_pc.coords, ref_pc.mask)
        got = TM.downsample(pc, factor)
        eq(got.coords, want.coords)
        eq(got.mask, want.mask)
        assert got.stride == want.stride == factor


@pytest.mark.parametrize("ks,stride", [(3, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("kind", KINDS[:4])
def test_kernel_map_equals_reference(kind, ks, stride):
    """Every map array equal, slot for slot, to the reference's v1 build
    (the output cloud of a strided conv too)."""
    coords, mask = edge_cloud(kind, seed=2 + ks)
    ref_pc, pc = both(coords, mask)
    want, want_out = _ref_conv_maps(ks, stride)(ref_pc.coords, ref_pc.mask)
    got, got_out = TM.build_conv_maps(pc, ks, stride, engine="v1")
    for g, w in ((got.in_idx, want.in_idx), (got.out_idx, want.out_idx),
                 (got.valid, want.valid), (got_out.coords, want_out.coords),
                 (got_out.mask, want_out.mask)):
        eq(g, w)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.inv is None and got.in_idx.dtype == torch.int32
    assert int(got.valid.sum()) > 0
    # the scatter-built inverse table the kernel flows take
    eq(tspops.invert_maps(got, got_out.capacity),
       _ref_invert_maps(want_out.capacity)(want))


@pytest.mark.parametrize("cap", [5, 40, 400])
def test_kernel_map_explicit_cap_equals_reference(cap):
    coords, mask = edge_cloud("neg", seed=9)
    ref_pc, pc = both(coords, mask)
    want = jit(lambda c, m: M.kernel_map(
        M.PointCloud(c, m, 1), M.PointCloud(c, m, 1), 3, cap=cap))(
        ref_pc.coords, ref_pc.mask)
    got = TM.kernel_map(pc, pc, 3, cap=cap)
    for g, w in ((got.in_idx, want.in_idx), (got.out_idx, want.out_idx),
                 (got.valid, want.valid)):
        eq(g, w)


def _map_sets(maps):
    return [set(zip(i[v].tolist(), o[v].tolist())) for i, o, v in
            zip(maps.in_idx, maps.out_idx, maps.valid)]


@pytest.mark.parametrize("ks,stride", [(3, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_v1_equals_port_v2_up_to_order(ks, stride, seed):
    """Mirrors tests/test_mapping.py::test_engines_agree and
    test_v2_inverse_table_matches_v1_scatter on the port alone."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(20, 90))
    coords, mask = random_cloud(rng, n, n + int(rng.integers(0, 16)),
                                grid=int(rng.integers(4, 14)))
    if seed % 2:
        coords[mask.nonzero()[0], 1:] -= 17
    _, pc = both(coords, mask)
    m1, o1 = TM.build_conv_maps(pc, ks, stride, engine="v1")
    m2, o2 = TM.build_conv_maps(pc, ks, stride, engine="v2")
    eq(o1.coords, o2.coords.numpy())
    eq(o1.mask, o2.mask.numpy())
    assert _map_sets(m1) == _map_sets(m2)
    eq(tspops.invert_maps(m1, o1.capacity), m2.inv.numpy())
    if stride > 1:
        eq(tspops.invert_maps(m1.swap(), pc.capacity),
           m2.swap(require_inverse=True).inv.numpy())
    with pytest.raises(ValueError, match="no inverse table"):
        m1.swap(require_inverse=True)


def test_engine_rule_for_two_dims_and_the_key_budget():
    """The default engine falls back to v1 for D = 2; an explicit v2
    raises there, and on points outside the packed-key budget, which v1
    takes."""
    coords = np.array([[0, 1, 2], [0, 2, 2]], np.int32)
    _, pc = both(coords, np.ones(2, bool))
    maps, _ = TM.build_conv_maps(pc, 3, 1)
    assert maps.offsets.shape == (9, 2) and int(maps.valid.sum()) == 4
    with pytest.raises(ValueError, match="3 spatial dims"):
        TM.build_conv_maps(pc, 3, 1, engine="v2")
    with pytest.raises(ValueError, match="unknown mapping engine"):
        TM.build_conv_maps(pc, 3, 1, engine="v3")
    far = np.array([[20000, 40000, 0, 0], [20000, 40001, 0, 0]], np.int32)
    _, pc = both(far, np.ones(2, bool))
    with pytest.raises(ValueError, match="engine='v1'"):
        TM.build_conv_maps(pc, 3, 1, engine="v2")
    maps, out = TM.build_conv_maps(pc, 3, 2, engine="v1")
    assert int(out.mask.sum()) == 1 and int(maps.valid.sum()) == 2


# ---------------------------------------------------------------------------
# the session and the MapContext
# ---------------------------------------------------------------------------

def _feats(rng, cap, cin, mask):
    f = rng.normal(size=(cap, cin)).astype(np.float32)
    f[~mask] = 0
    return f


def test_session_v1_transposed_warns_like_reference():
    """Mirrors tests/test_session.py::
    test_swap_require_inverse_raises_for_v1_maps: v1 maps warn on the
    kernel flows and agree with the plain flow and with the reference."""
    from repro.api import PointAccSession as RefSession
    rng = np.random.default_rng(2)
    coords, mask = random_cloud(rng, 60, 96, grid=12)
    feats = _feats(rng, 96, 6, mask)
    w_down = rng.normal(size=(8, 6, 12)).astype(np.float32)
    w_up = rng.normal(size=(8, 12, 5)).astype(np.float32)
    t = torch.from_numpy
    _, pc = both(coords, mask)

    down = TSC.sparse_conv(pc, t(feats), t(w_down), 2, 2, engine="v1")
    plain = TSC.sparse_conv_transposed(down.features, down.maps, pc,
                                       t(w_up), flow="fod")
    with pytest.warns(UserWarning, match="engine='v1'"):
        out = TSC.sparse_conv_transposed(down.features, down.maps, pc,
                                         t(w_up), flow="cuda_fused")
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)

    v1s = PointAccSession(engine="v1", flow="cuda_fused")
    x = v1s.tensor(t(coords), t(mask), t(feats))
    assert x.context.engine == "v1"
    h = v1s.conv(x, t(w_down), stride=2)
    assert v1s.canonicalized(x) == (x, None)
    with pytest.warns(UserWarning, match="scatter-built inverse"):
        y = v1s.conv_transposed(h, t(w_up), stride=2)
    @jit
    def ref(c, m, f, wd, wu):
        s = RefSession(engine="v1", flow="fod")
        rh = s.conv(s.tensor(c, m, f), wd, stride=2)
        return rh.coords, s.conv_transposed(rh, wu, stride=2).feats

    want_coords, want = ref(coords, mask, feats, w_down, w_up)
    np.testing.assert_allclose(y.feats.numpy(), np.asarray(want), **TOL)
    eq(h.coords, want_coords)
    assert y.context.maps.keys() == {(2, 1, 2)}
    v2s = PointAccSession(engine="v2", flow="cuda_fused")
    h2 = v2s.conv(v2s.tensor(t(coords), t(mask), t(feats)), t(w_down),
                  stride=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        v2s.conv_transposed(h2, t(w_up), stride=2)


def _two_dim_inputs():
    rng = np.random.default_rng(20)
    coords, mask = random_cloud(rng, 40, 64, grid=8, d=2)
    feats = _feats(rng, 64, 5, mask)
    w = rng.normal(size=(9, 5, 7)).astype(np.float32)
    w_up = rng.normal(size=(9, 7, 3)).astype(np.float32)
    return coords, mask, feats, w, w_up


@functools.lru_cache(maxsize=None)
def _two_dim_reference():
    """The reference session's subm, strided and transposed convs of the
    D = 2 cloud: [(feats, coords, mask)] as numpy."""
    from repro.api import PointAccSession as RefSession

    @jit
    def ref(c, m, f, w, wu):
        s = RefSession(flow="fod")
        rx = s.tensor(c, m, f)
        assert rx.context.engine == "v1"
        down = s.conv(rx, w, stride=2)
        out = [s.conv(rx, w), down, s.conv_transposed(down, wu, stride=2)]
        return [(o.feats, o.coords, o.mask) for o in out]

    return jax.tree_util.tree_map(np.asarray, ref(*_two_dim_inputs()))


@pytest.mark.parametrize("flow", ["fod", "cuda", "cuda_fused"])
def test_session_two_dim_cloud_matches_reference(flow):
    """D = 2 through the default engine (v1 by inference): subm and strided
    convs and the transposed conv against the reference's session."""
    coords, mask, feats, w, w_up = _two_dim_inputs()
    t = torch.from_numpy
    session = PointAccSession(flow=flow)
    x = session.tensor(t(coords), t(mask), t(feats))
    assert x.context.engine == "v1"
    got = [session.conv(x, t(w))]
    got.append(session.conv(x, t(w), stride=2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got.append(session.conv_transposed(got[1], t(w_up), stride=2))

    for g, (f, c, m), stride in zip(got, _two_dim_reference(), (1, 2, 1)):
        np.testing.assert_allclose(g.feats.numpy(), np.asarray(f), **TOL)
        eq(g.coords, c)
        eq(g.mask, m)
        assert g.stride == stride


def test_padded_tensor_keeps_its_engine():
    coords, mask = edge_cloud("far", seed=4, n=30, cap=40)
    session = PointAccSession(engine="v1")
    x = session.tensor(torch.from_numpy(coords), torch.from_numpy(mask),
                       torch.zeros(40, 2))
    y = x.padded_to(64)
    assert y.context.engine == "v1" and y.capacity == 64
    maps, _ = y.context.conv_maps(3, 1)
    assert int(maps.valid.sum()) >= int(mask.sum())


# ---------------------------------------------------------------------------
# serving: segment, the scheduler and partitioning on a v1 engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v1_engines():
    """The reference's v1 engine (flow "fod") and the port's (v1 and v2,
    flow "cuda_fused") over the same mini-MinkUNet weights."""
    from repro.models import minkunet as MU
    from repro.serve.buckets import geometric_ladder as ref_ladder
    from repro.serve.engine import PointCloudEngine as RefEngine
    from repro_torch.models import minkunet as TMU
    from repro_torch.serve.buckets import geometric_ladder
    from repro_torch.serve.engine import PointCloudEngine

    module = TMU.mini_minkunet_init(torch.Generator().manual_seed(0), c_in=4,
                                    n_classes=3)
    params = reference_tree(module, lambda k: MU.mini_minkunet_init(
        k, c_in=4, n_classes=3), jax.random.key(1))
    module = TMU.load_jax_params(module,
                                 jax.tree_util.tree_map(np.asarray, params))
    ref = RefEngine(params, n_stages=2, flow="fod", engine="v1",
                    ladder=ref_ladder(*LADDER), max_batch=2, mesh=None)

    def port(engine):
        return PointCloudEngine(module, 2, device="cpu", engine=engine,
                                ladder=geometric_ladder(*LADDER),
                                max_batch=2)
    return ref, port


def _scenes():
    """A scene in the budget, it moved past +32767 in x (65536, a multiple
    of every level's stride), and one at batch index 20000."""
    c, m, f = S.lidar_scene(31, 200, grid=16)
    far = c.copy()
    far[m, 1] += 65536
    hi_batch = c.copy()
    hi_batch[m, 0] = 20000
    return [(c, m, f), (far, m, f), (hi_batch, m, f)]


def test_v1_segment_matches_reference_in_and_out_of_budget(v1_engines):
    ref, port = v1_engines
    v1, v2 = port("v1"), port("v2")
    (c, m, f), *outside = _scenes()
    base, _ = v2.segment(c, m, f)
    from repro_torch.kernels.spconv import spconv as TK
    TK.reset_launch_counts()
    for coords, mask, feats in [(c, m, f)] + outside:
        want, _ = ref.segment(coords, mask, feats)
        got, hit = v1.segment(coords, mask, feats)
        assert hit is False and got.dtype == torch.int32
        eq(got[mask], np.asarray(want)[mask])
        # the moved scenes quantise as the original at every level
        eq(got[mask], base.numpy()[mask])
    assert not any(TK.LAUNCHES.values())          # the CPU path counts none
    levels, hit = v1.levels_for(c, m)
    assert hit and all("cloud" not in lv for lv in levels)
    with pytest.raises(ValueError, match="engine='v1'"):
        v2.segment(*outside[0])


def test_v1_scheduler_serves_what_v2_refuses(v1_engines):
    from repro.serve.scheduler import ServeScheduler as RefScheduler
    from repro_torch.serve.buckets import geometric_ladder
    from repro_torch.serve.faults import AdmissionError, validate_scene
    from repro_torch.serve.scheduler import ServeScheduler
    ref, port = v1_engines
    ref.session.maps_cache.__init__(32)
    scenes = _scenes()
    ref_sched = RefScheduler(ref, max_batch=2, mesh=None, pipeline_depth=0)
    rids = [ref_sched.submit(c, f, m) for c, m, f in scenes]
    ref_sched.flush()
    want = ref_sched.take(rids)
    for eng, ok in (("v1", True), ("v2", False)):
        sched = ServeScheduler(port(eng), max_batch=2)
        got_ids = [sched.submit(c, f, m) for c, m, f in scenes]
        sched.flush()
        got = sched.take(got_ids)
        for i, (gid, wid, (c, m, f)) in enumerate(zip(got_ids, rids,
                                                      scenes)):
            r = got[gid]
            if ok or i == 0:
                assert r.ok, r.error
                eq(torch.from_numpy(np.asarray(r.preds))[m],
                   np.asarray(want[wid].preds)[m])
            else:
                assert not r.ok and r.error.code == "rejected"
                assert "packed-key budget" in r.error.message
    c, m, f = scenes[1]
    with pytest.raises(AdmissionError, match="packed-key budget"):
        validate_scene(c, f, m, geometric_ladder(*LADDER))
    validate_scene(c, f, m, geometric_ladder(*LADDER),
                   check_key_budget=False)


@pytest.mark.parametrize("scene", [0, 1])
def test_v1_partitioned_segment_does_what_reference_does(v1_engines, scene):
    """segment(partition=) on a v1 engine: the same labels as the
    reference's, or the same error type."""
    from repro.partition import PartitionPolicy as RefPolicy
    from repro_torch.partition import PartitionPolicy
    ref, port = v1_engines
    ref.session.maps_cache.__init__(32)
    ref._scheduler = None
    c, m, f = _scenes()[scene]

    def run(fn):
        try:
            return fn(), None
        except Exception as e:          # the error's type is compared
            return None, type(e).__name__

    want, want_err = run(lambda: ref.segment(
        c, m, f, partition=RefPolicy(chunk_budget=96, force=True))[0])
    got, got_err = run(lambda: port("v1").segment(
        c, m, f, partition=PartitionPolicy(chunk_budget=96, force=True))[0])
    assert got_err == want_err
    if want_err is None:
        eq(got[m], np.asarray(want)[m])


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["minkunet", "mini-minkunet"])
@pytest.mark.parametrize("reduced", [False, True])
def test_point_cloud_configs_equal_reference(name, reduced):
    from repro import configs as RC
    from repro_torch import configs as TC
    want = dataclasses.asdict(RC.get(name, reduced=reduced))
    got = dataclasses.asdict(TC.get(name, reduced=reduced))
    assert got == want
    assert name in TC.list_archs()


@pytest.mark.parametrize("seed,step,batch,n", [(0, 0, 2, 300), (3, 5, 3, 64)])
def test_point_cloud_batch_bit_equal(seed, step, batch, n):
    want = S.point_cloud_batch(seed, step, batch, n, grid=16)
    got = TS.point_cloud_batch(seed, step, batch, n, grid=16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
