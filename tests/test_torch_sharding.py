"""The port's sharding rules against the reference's, in one process.

The rules are pure functions of path names, shapes and mesh axis sizes,
so both sides run on meshes with no devices behind them: the reference's
`jax.sharding.AbstractMesh` and the port's `sharding.AbstractMesh`.  The
parameter specs are held over every leaf of all ten LM configs' full-size
trees (the reference's `jax.eval_shape`, the port's meta tensors of the
same shapes), the decode-state specs over the port's own state trees on
the meta device, the activation / batch specs over a table that reaches
every branch.  Also: the expert-parallel dispatch tables and the int8
quantiser (integers and bits equal), DTensor placements, the mesh
constructors' world-size check, and the scene mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RAbstractMesh

from repro import configs as RC
from repro.configs.base import list_archs
from repro.distributed import compression as RCMP
from repro.distributed import sharding as RSH
from repro.models import moe as RMOE
from repro.models import registry as RR
from repro_torch import configs as TC
from repro_torch.distributed import compression as CMP
from repro_torch.distributed import sharding as SH
from repro_torch.models import moe as MOE
from repro_torch.models import registry as TR

from torch_parity import jit

LM_ARCHS = [n for n in list_archs() if RC.get(n).family != "pointcloud"]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                          "model")),
          ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _norm(spec):
    """A spec as a tuple of entries (1-tuples as names), trailing Nones
    dropped: the reference's PartitionSpec and the port's tuple alike."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, tuple) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _configs(shape, axes, **kw):
    return (RSH.ShardingConfig(RAbstractMesh(shape, axes), **kw),
            SH.ShardingConfig(SH.AbstractMesh(shape, axes), **kw))


def _ref_paths(tree, fn):
    """{dotted path: fn(leaf)} over a reference tree."""
    return {".".join(RSH._path_names(p)): fn(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree, out=None):
    """{dotted path: leaf} over a port tree; with `out` (a tree of specs
    shaped as `tree`, whose tuple leaves are not nodes), out's leaves."""
    got = {}

    def visit(path, leaf):
        node = out
        for k in (path if out is not None else ()):
            node = node[k] if isinstance(node, dict) else \
                (getattr(node, k) if hasattr(node, "_fields") else
                 node[int(k)])
        got[".".join(path)] = leaf if out is None else node
    SH.tree_map_with_path(visit, tree)
    return got


def _meta(shapes):
    """The reference's abstract tree as meta tensors (nested dicts)."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)


@pytest.fixture(scope="module")
def param_shapes():
    return {n: jax.eval_shape(RR.build(RC.get(n)).init, jax.random.key(0))
            for n in LM_ARCHS}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_params_shardings_equal_reference_full_size(param_shapes, mesh, fsdp):
    """param_spec / params_shardings over every leaf of the ten LM configs'
    full-size trees: the port's specs equal the reference's."""
    rsc, tsc = _configs(*mesh, fsdp=fsdp)
    n = 0
    for arch, shapes in param_shapes.items():
        ref = _ref_paths(RSH.params_shardings(shapes, rsc),
                         lambda s: _norm(s.spec))
        meta = _meta(shapes)
        got = {k: _norm(v) for k, v in _port_paths(
            meta, SH.params_shardings(meta, tsc)).items()}
        assert got == ref, arch
        n += len(ref)
    assert n > 250


ACTIVATIONS = [
    ((8, 64, 2048), ("batch", "seq", "d_model")),
    ((8, 17, 2048), ("batch", "seq", "d_model")),       # seq indivisible
    ((3, 64, 2048), ("batch", "seq", "d_model")),       # batch indivisible
    ((1, 4096, 2048), ("batch", "seq", "d_model")),     # long context
    ((8, 64, 2048), ("batch", "seq_full", "d_model")),
    ((8, 64, 32, 128), ("batch", "seq", "heads", "head_dim")),
    ((8, 64, 12, 64), ("batch", "seq", "heads", "head_dim")),
    ((8, 64, 8, 128), ("batch", "seq", "kv_heads", "head_dim")),
    ((1, 4096, 8, 128), ("batch", "seq", "kv_heads", "head_dim")),
    ((8, 64, 8192), ("batch", "seq", "d_ff")),
    ((8, 64, 4096), ("batch", "seq", "d_inner")),
    ((8, 64, 32000), ("batch", "seq", "vocab")),
    ((1, 64, 256000), ("batch", "seq", "vocab")),
    ((8, 16, 4096), ("batch", "heads", "d_ff")),        # model axis twice
    ((16, 4096, 16), ("batch", "d_model", "heads")),
]


@pytest.mark.parametrize("flags", [(True, False), (False, False),
                                   (True, True), (False, True)],
                         ids=["sp", "nosp", "sp-seqdata", "nosp-seqdata"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_shard_fn_batch_and_state_specs_equal_reference(monkeypatch, mesh,
                                                        flags):
    """make_shard_fn's constraint (captured from the reference by patching
    `with_sharding_constraint`), batch_specs and state_specs equal the
    reference's over a table of names and shapes that reaches every
    branch, with and without SP and long-context seq sharding."""
    sp, seq_data = flags
    rsc, tsc = _configs(*mesh, seq_parallel=sp,
                        shard_seq_over_data=seq_data)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(_norm(s.spec)) or x)
    rshard = RSH.make_shard_fn(rsc)
    for shape, names in ACTIVATIONS:
        rshard(jax.ShapeDtypeStruct(shape, jnp.float32), names)
        assert _norm(SH.activation_spec(tsc, shape, names)) == seen[-1], \
            (shape, names)
    batches = {"tokens": (8, 64), "labels": (3, 64), "long": (1, 4096),
               "positions": (8, 64, 3), "odd": (1, 7)}
    ref = _ref_paths(RSH.batch_specs(
        {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batches.items()},
        rsc), lambda s: _norm(s.spec))
    got = {k: _norm(v) for k, v in SH.batch_specs(
        {k: torch.empty(v, device="meta") for k, v in batches.items()},
        tsc).items()}
    assert got == ref


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_state_specs_equal_reference_full_size(arch):
    """state_specs over the port's own decode-state trees (built on the
    meta device) equal the reference's over its abstract ones: KV caches
    by batch or sequence, heads or flash-decoding over 'model', SSM and
    xLSTM states by batch and width."""
    rmodel, tmodel = RR.build(RC.get(arch)), TR.build(TC.get(arch))
    for b, length in ((4, 64), (1, 256), (3, 32)):
        rstate = jax.eval_shape(lambda: rmodel.init_state(b, length))
        tstate = tmodel.init_state(b, length, device="meta")
        rpaths = _ref_paths(rstate, lambda s: tuple(s.shape))
        tpaths = _port_paths(tstate)
        assert {k: tuple(v.shape) for k, v in tpaths.items()} == rpaths
        for mesh in MESHES:
            for kv in (True, False):
                rsc, tsc = _configs(*mesh, kv_seq_over_model=kv)
                ref = _ref_paths(RSH.state_specs(rstate, rsc),
                                 lambda s: _norm(s.spec))
                got = {k: _norm(v) for k, v in _port_paths(
                    tstate, SH.state_specs(tstate, tsc)).items()}
                assert got == ref, (arch, b, length, mesh, kv)


@pytest.mark.parametrize("e,ep,t,topk,cap,skew", [
    (8, 4, 40, 2, 8, False), (8, 4, 40, 2, 3, True), (2, 4, 24, 2, 8, False),
    (2, 4, 24, 2, 2, True), (8, 2, 17, 4, 16, False), (4, 4, 32, 1, 4, True)])
def test_make_ep_dispatch_equals_reference(e, ep, t, topk, cap, skew):
    """make_ep_dispatch's dest_row / src_token equal the reference's
    exactly, for E >= ep and E < ep (replicated experts), with capacity
    drops."""
    rng = np.random.default_rng(t * 7 + cap)
    if skew:
        idx = np.minimum(rng.geometric(0.5, size=(t, topk)) - 1, e - 1)
    else:
        idx = np.stack([rng.permutation(e)[:topk] for _ in range(t)])
    idx = idx.astype(np.int32)
    rd, rs = jit(RMOE.make_ep_dispatch, static_argnums=(1, 2, 3))(
        jnp.asarray(idx), e, ep, cap)
    td, ts = MOE.make_ep_dispatch(torch.from_numpy(idx), e, ep, cap)
    assert td.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    assert (td.numpy() < 0).any() == (np.asarray(rd) < 0).any()


@pytest.mark.parametrize("shape,scale", [((300,), 1.0), ((2, 513), 1e-3),
                                         ((4, 256), 1e4), ((1, 7), 0.0)])
def test_int8_quantiser_bit_equal(shape, scale):
    """_quantize_int8 / _dequantize: payload, scales and the dequantised
    values bit-equal to the reference's (an all-zero block takes the
    1e-12 floor)."""
    v = (np.random.default_rng(3).normal(size=shape) * scale).astype(
        np.float32)
    if v.size > 256:
        v.reshape(-1)[:256] = 0.0
    rq, rs = RCMP._quantize_int8(jnp.asarray(v))
    tq, ts = CMP._quantize_int8(torch.from_numpy(v))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    rd = RCMP._dequantize(rq, rs, shape, jnp.float32)
    td = CMP._dequantize(tq, ts, shape, torch.float32)
    np.testing.assert_array_equal(td.numpy().view(np.uint32),
                                  np.asarray(rd).view(np.uint32))


def test_placements_and_mesh_world_size(tmp_path):
    """Specs become DTensor placements (a tuple entry nests its axes in
    mesh order; an axis of size 1 stays Replicate); a mesh whose size is
    not the world's raises ValueError naming both; a 1 x 1 mesh builds
    over a world of one."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as MESH
    mesh = SH.AbstractMesh((2, 4, 1), ("pod", "data", "model"))
    assert SH.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Replicate()]
    assert SH.placements((None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(RuntimeError, match="process group"):
        MESH.make_debug_mesh(device_type="cpu")
    # the card by default: no quiet CPU mesh on a host without one
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        MESH.make_mesh((1, 1), ("data", "model"))
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        for multi in (False, True):
            with pytest.raises(ValueError, match="world size 1"):
                MESH.make_debug_mesh(multi_pod=multi, device_type="cpu")
            with pytest.raises(ValueError, match="256|512"):
                MESH.make_production_mesh(multi_pod=multi, device_type="cpu")
        m = MESH.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        x = torch.arange(12.).reshape(3, 4)
        d = SH.constrain(x, ("data", "model"), m)
        assert torch.equal(d.full_tensor(), x) and torch.equal(SH.full(x), x)
    finally:
        torch.distributed.destroy_process_group()


def test_scene_mesh_and_shard_over_scenes():
    """make_scene_mesh is None for fewer than two devices (this host has
    no card); shard_over_scenes splits tensors and per-scene lists over
    the devices and concatenates the outputs in scene order."""
    assert SH.make_scene_mesh() is None
    assert SH.make_scene_mesh(devices=["cpu"]) is None
    mesh = SH.make_scene_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis == "scene"
    calls = []

    def fn(levels, x):
        calls.append(list(levels))
        return x * 2 + torch.tensor([len(levels)])[:, None]
    f = SH.shard_over_scenes(fn, mesh)
    x = torch.arange(8.).reshape(4, 2)
    out = f([{"a": torch.ones(1)}, None, 3, 4], x)
    assert torch.equal(out, x * 2 + 2)
    assert len(calls) == 2 and calls[1] == [3, 4]
    with pytest.raises(ValueError, match="divisible"):
        f([1, 2, 3], x[:3])
