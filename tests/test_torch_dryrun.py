"""The port's multi-pod dry run (`launch/dryrun.py`, `launch/roofline.py`,
`launch/shapes.input_specs` / `decode_state_specs`, `costmode.py`,
`compat.py`) and the dispatcher ops of the four LM kernels, held to the
reference where it has a counterpart.

The reference's own dry run fails under this jax (every cell raises at
`with_sharding_constraint`), so it is held to by its parts: the input and
state specs, the parameter counts and bytes per device, and the roofline
arithmetic.  Everything here is abstract (ShapeDtypeStructs, meta and fake
tensors), so the full-size configs cost no memory.

This CPU build of torch cannot index, copy or differentiate fake CUDA
tensors (it has no CUDA device guard), so the fake steps that go through the
kernel ops run on fake "meta" tensors: like CUDA tensors they are not CPU
tensors, so every wrapper takes its op, whose fake implementation runs.
On the card `chip_smoke.py` phase 17 runs the same steps on fake CUDA
tensors and holds them against real steps.
"""

import math
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RAbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as RC
from repro.distributed import sharding as RSH
from repro.launch import roofline as RRL
from repro.launch import shapes as RSHAPES
from repro.models import registry as RR
from repro_torch import compat, costmode
from repro_torch import configs as TC
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import flash_attention as FAK
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import flash_decode as FDK
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.grouped_matmul import grouped_matmul as GMK
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_dw_ref,
                                                   grouped_matmul_ref)
from repro_torch.launch import dryrun as D
from repro_torch.launch import flops as FL
from repro_torch.launch import roofline as RL
from repro_torch.launch import shapes as SHAPES
from repro_torch.models import registry as TR
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401

ARCHS = D.LM_ARCHS
PROD_MESHES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _ref_leaves(tree) -> dict:
    """{dotted path: (shape, dtype name)} over a reference tree."""
    return {".".join(RSH._path_names(p)): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    got = {}

    def visit(path, x):
        got[".".join(path)] = (tuple(x.shape), _name(x.dtype))
    SH.tree_map_with_path(visit, tree)
    return got


@pytest.fixture(scope="module")
def ref_params():
    return {a: jax.eval_shape(RR.build(RC.get(a)).init, jax.random.key(0))
            for a in ARCHS}


@pytest.fixture(scope="module")
def port_params():
    return {a: D.param_meta(TC.get(a)) for a in ARCHS}


# ---------------------------------------------------------------------------
# input and state specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", D.ALL_SHAPES)
def test_input_specs_equal_reference(shape):
    """Keys, shapes and dtypes of every LM arch's batch at each shape."""
    for arch in ARCHS:
        ref = RSHAPES.input_specs(RC.get(arch), RSHAPES.SHAPES[shape])
        got = SHAPES.input_specs(TC.get(arch), SHAPES.SHAPES[shape])
        assert set(got) == set(ref), arch
        for k, spec in ref.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (arch, k)
            assert _name(got[k].dtype) == str(spec.dtype), (arch, k)
            assert got[k].device.type == "meta"


def test_decode_state_specs_equal_reference():
    """Every leaf of each arch's decode state at decode_32k (the reference's
    `init_state` under `jax.eval_shape`; the port's on the meta device)."""
    shape_r, shape_t = RSHAPES.SHAPES["decode_32k"], SHAPES.SHAPES[
        "decode_32k"]
    n = 0
    for arch in ARCHS:
        rcfg, tcfg = RC.get(arch), TC.get(arch)
        ref = _ref_leaves(RSHAPES.decode_state_specs(RR.build(rcfg), rcfg,
                                                     shape_r))
        got = _port_leaves(SHAPES.decode_state_specs(TR.build(tcfg), tcfg,
                                                     shape_t))
        assert got == ref, arch
        n += len(ref)
    assert n > 30


# ---------------------------------------------------------------------------
# parameter counts and bytes
# ---------------------------------------------------------------------------

def _ref_active(cfg, tree):
    """The reference dry run's expert rule (`dryrun.py` n_active_params)."""
    total, expert = 0, 0
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        n = int(np.prod(leaf.shape))
        total += n
        names = RSH._path_names(p)
        if names and names[-1] in ("w_in", "w_gate", "w_out"):
            expert += n
    if cfg.n_experts:
        return total - expert + expert * cfg.topk / cfg.n_experts
    return total


def test_param_counts_equal_reference(ref_params, port_params):
    """n_params and n_active_params of every LM arch at full size; the
    port's tree (the init under a fake mode) has the reference's leaves."""
    for arch in ARCHS:
        ref, got = ref_params[arch], port_params[arch]
        assert _port_leaves(got) == _ref_leaves(ref), arch
        assert D.n_params(got) == sum(int(np.prod(x.shape)) for x in
                                      jax.tree_util.tree_leaves(ref))
        assert D.n_active_params(TC.get(arch), got) == \
            _ref_active(RC.get(arch), ref), arch
    assert D.n_params(port_params["qwen2-vl-72b"]) > 7e10


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", PROD_MESHES, ids=["16x16", "2x16x16"])
def test_param_bytes_per_device_equal_reference(ref_params, port_params,
                                                mesh, fsdp):
    """device_bytes over the port's specs equals the reference dry run's
    arithmetic over `params_shardings` on an AbstractMesh."""
    shape, axes = mesh
    rmesh, tmesh = RAbstractMesh(shape, axes), SH.AbstractMesh(shape, axes)
    rsc = RSH.ShardingConfig(rmesh, fsdp=fsdp)
    tsc = SH.ShardingConfig(tmesh, fsdp=fsdp)
    sizes = dict(zip(axes, shape))
    for arch in ARCHS:
        ref, meta = ref_params[arch], port_params[arch]
        shards = jax.tree_util.tree_leaves(
            RSH.params_shardings(ref, rsc), is_leaf=lambda x: hasattr(
                x, "spec"))
        want = 0.0
        for leaf, s in zip(jax.tree_util.tree_leaves(ref), shards):
            div = 1
            for ax in s.spec:
                for a in (() if ax is None else
                          (ax if isinstance(ax, tuple) else (ax,))):
                    div *= sizes[a]
            want += int(np.prod(leaf.shape)) * leaf.dtype.itemsize / div
        got = D.device_bytes(meta, SH.params_shardings(meta, tsc), tmesh)
        assert got == pytest.approx(want, rel=1e-12), arch


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

def test_roofline_arithmetic_equals_reference():
    """extrapolate, model_flops and CellCost.terms on the same inputs; the
    terms with each side's constants divided out (the port's are the
    H100's, the reference's a TPU's)."""
    c1, c2 = {"flops": 3.5e12, "bytes": 2.25e11}, {"flops": 5.0e12,
                                                   "bytes": 2.0e11}
    k1 = {"all-reduce": 1e8, "all-gather": 3e7, "all-to-all": 5e6}
    k2 = {"all-reduce": 1.5e8, "all-gather": 2e7, "reduce-scatter": 4e6,
          "collective-permute": 1e6}
    for n in (1, 2, 24, 80):
        ref = RRL.extrapolate(c1, c2, k1, k2, n)
        got = RL.extrapolate(c1, c2, k1, k2, n)
        assert (got.flops, got.hbm_bytes, got.coll_bytes_per_chip,
                got.coll_by_kind) == (ref.flops, ref.hbm_bytes,
                                      ref.coll_bytes_per_chip,
                                      ref.coll_by_kind)
        assert RL.COLL_KINDS == RRL._COLL_KINDS
        for hw in RL.H100.values():
            for af in (None, 7.25e13):
                r, t = ref.terms(af), got.terms(af, hw)
                assert t["compute_s"] * hw.peak_flops == pytest.approx(
                    r["compute_s"] * RRL.PEAK_FLOPS, rel=1e-12)
                assert t["memory_s"] * hw.hbm_bw == pytest.approx(
                    r["memory_s"] * RRL.HBM_BW, rel=1e-12)
                assert t["collective_s"] * hw.link_bw == pytest.approx(
                    r["collective_s"] * RRL.ICI_BW, rel=1e-12)
    for arch in ("granite-moe-1b-a400m", "qwen2-vl-72b"):
        for shape in D.ALL_SHAPES:
            for tokens in (None, 4096):
                assert RL.model_flops(TC.get(arch), SHAPES.SHAPES[shape],
                                      1.25e9, tokens) == RRL.model_flops(
                    RC.get(arch), RSHAPES.SHAPES[shape], 1.25e9, tokens)


def test_hardware_is_the_cards():
    """The H100's data-sheet figures by card name; no TPU figure."""
    sxm, pcie = RL.hardware("NVIDIA H100 80GB HBM3"), RL.hardware(
        "NVIDIA H100 PCIe")
    assert (sxm.peak_flops, sxm.hbm_bw) == (989e12, 3.35e12)
    assert (pcie.peak_flops, pcie.hbm_bw) == (756e12, 2.0e12)
    assert RL.hardware() == sxm and sxm.link_bw == 50e9
    assert 197e12 not in sxm and 819e9 not in sxm


# ---------------------------------------------------------------------------
# the kernel ops: fake implementations and FLOP formulas
# ---------------------------------------------------------------------------

def _fake_call(device, fn, *args):
    """fn on fake tensors of args' shapes and dtypes on `device` -> (the
    output's shape, dtype, device type, FlopCounterMode's count)."""
    with FakeTensorMode():
        fakes = [torch.empty(a.shape, dtype=a.dtype, device=device)
                 if isinstance(a, torch.Tensor) else a for a in args]
        with FlopCounterMode(display=False) as fc:
            out = fn(*fakes)
        return tuple(out.shape), out.dtype, out.device.type, \
            fc.get_total_flops()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_op_fake_and_flops(dtype, window):
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d = 2, 4, 2, 12, 16
    q = torch.randn((b, hq, s, d), generator=g).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g).to(dtype)
    want = attention_ref(q, k, k, causal=True, window=window)
    for device in ("cuda", "meta"):
        shape, dt, dev, flops = _fake_call(
            device, lambda q, k: FAK.flash_attention_cuda(
                q, k, k, causal=True, window=window), q, k)
        assert (shape, dt, dev) == (tuple(want.shape), want.dtype, device)
        # QK^T and PV over the kept pairs: launch/flops.attn_flops' count
        assert flops == round(4 * b * hq * d * s * FL._attn_len(s, s,
                                                                window))
    for sq, w in ((1, None), (7, 3), (64, None), (64, 16), (100, 100)):
        assert FAK.kept_pairs(sq, sq, True, w) == round(
            sq * FL._attn_len(sq, sq, w))
    assert FAK.kept_pairs(4, 6, False, None) == 24


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_ops_fake_and_flops(dtype):
    g = torch.Generator().manual_seed(1)
    r, cin, cout, e, tile = 256, 24, 40, 3, 128
    x = torch.randn((r, cin), generator=g).to(dtype)
    w = torch.randn((e, cin, cout), generator=g).to(dtype)
    dy = torch.randn((r, cout), generator=g).to(dtype)
    eid = torch.tensor([2, 0], dtype=torch.int32)
    cases = [
        (lambda x, eid, w: GMK.grouped_matmul_cuda(x, eid, w, tile),
         (x, eid, w), grouped_matmul_ref(x, eid, w, tile)),
        (lambda dy, eid, w: GMK.grouped_matmul_dx_cuda(dy, eid, w, tile),
         (dy, eid, w), grouped_matmul_ref(dy, eid, w.transpose(1, 2), tile)),
        (lambda x, dy, eid: GMK.grouped_matmul_dw_cuda(x, dy, eid, e, tile),
         (x, dy, eid), grouped_matmul_dw_ref(x, dy, eid, e, tile)),
    ]
    for i, (fn, args, want) in enumerate(cases):
        # dX transposes the weights first: a copy this build cannot make of
        # a fake CUDA tensor
        for device in ("cuda", "meta") if i != 1 else ("meta",):
            shape, dt, dev, flops = _fake_call(device, fn, *args)
            assert (shape, dt, dev) == (tuple(want.shape), want.dtype,
                                        device)
            assert flops == 2 * r * cin * cout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_op_fake_and_flops(dtype):
    g = torch.Generator().manual_seed(2)
    b, hq, hkv, s, hd = 3, 8, 2, 20, 16
    q = torch.randn((b, hq, hd), generator=g).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g).to(dtype)
    lengths = torch.tensor([20, 3, 0], dtype=torch.int32)
    want = flash_decode_ref(q, k, k, lengths)
    for device in ("cuda", "meta"):
        shape, dt, dev, flops = _fake_call(
            device, lambda q, k, n: FDK.flash_decode_cuda(q, k, k, n),
            q, k, lengths)
        assert (shape, dt, dev) == (tuple(want.shape), want.dtype, device)
        assert flops == 4 * b * hq * s * hd     # every cache slot


# ---------------------------------------------------------------------------
# counting on a fake mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def debug_mesh():
    """A fake (2, 4) "cpu" mesh: rank 0 of a world of 8."""
    with D.fake_world(8):
        yield D.mesh_of(False, True, "cpu")


def test_counter_counts_the_local_product_once(debug_mesh):
    """A DTensor product is counted at the shard's shapes only, once.  A
    FlopCounterMode around the same product counts it at the global
    shapes (the op as DTensor receives it), which is not a chip's work."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m, k, n = 264, 520, 1032          # a signature no other test uses
    with compat.fake_safe_dtensor(), FakeTensorMode():
        x = DTensor.from_local(torch.empty((m // 2, k), dtype=torch.bfloat16),
                               debug_mesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(torch.empty((k, n // 4), dtype=torch.bfloat16),
                               debug_mesh, [Replicate(), Shard(1)],
                               run_check=False)
        with FlopCounterMode(display=False) as fc:
            y = x @ w
        assert tuple(y.to_local().shape) == (m // 2, n // 4)
        with D.CostCounter() as cc:
            x @ w
    local = 2 * (m // 2) * k * (n // 4)
    assert cc.flops == local
    assert fc.get_total_flops() >= 2 * m * k * n == 8 * local
    assert cc.bytes == 2 * ((m // 2) * k + k * (n // 4) + local // (2 * k))


def test_mamba_runs_on_its_d_inner_shards(debug_mesh, monkeypatch):
    """Under a sharding config mamba's conv and scan run on each rank's
    d_inner channels, where `params_shardings` and `state_specs` put the
    weights and states: a reduced jamba's prefill and decode step on the
    fake (2, 4) debug mesh hand the scan a quarter of d_inner and half of
    the batch (a replicated mixer would see all of d_inner)."""
    from repro_torch.models import mamba as MB
    seen = []

    def spy(real):
        def fn(dt, a, x, *rest):
            seen.append(tuple(x.shape))
            return real(dt, a, x, *rest)
        return fn
    monkeypatch.setattr(MB, "scan", spy(MB.scan))
    monkeypatch.setattr(MB, "_scan_step", spy(MB._scan_step))
    cfg = TC.get("jamba-v0.1-52b", reduced=True)
    di = cfg.ssm_expand * cfg.d_model
    n_p = D.n_params(D.param_meta(cfg))
    for shape in (SHAPES.ShapeSpec("p", "prefill", 128, 4),
                  SHAPES.ShapeSpec("d", "decode", 128, 4)):
        sc = D.cell_sharding(debug_mesh, shape, n_p)
        got = D.count_step(cfg, shape, sc, torch.device("cpu"),
                           track_memory=False)
        assert got.flops > 0
    from repro_torch.models.lm import body_layout
    n_mamba = sum(sub.kind == "mamba" for sub in body_layout(cfg)) * \
        (cfg.n_layers // cfg.block_pattern)
    assert {(b, d) for b, _, d in seen} == {(2, di // 4)}
    assert len(seen) == 2 * n_mamba > 0


@pytest.mark.parametrize("kind", ["all-gather", "all-to-all"])
def test_counter_counts_a_redistribute(debug_mesh, kind, monkeypatch):
    """Shard(0) over "model" -> Replicate: one all-gather whose operand
    is the local shard's bytes.  Shard(0) -> Shard(1): one all-to-all of
    the local shard, `_dtensor::shard_dim_alltoall`, the op a CUDA mesh
    takes (a CPU mesh all-gathers instead; the test sends its mesh the
    CUDA mesh's way).  Nothing else moves, and the tracked peak holds the
    operand and one output of the shard's size."""
    import torch.distributed.tensor._collective_utils as CU
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if kind == "all-to-all":
        monkeypatch.setattr(CU, "local_tensor_mode", lambda: True)
    target = [Replicate(), Replicate() if kind == "all-gather" else Shard(1)]
    with compat.fake_safe_dtensor(), FakeTensorMode():
        local = torch.empty((16, 32), dtype=torch.float32)
        t = DTensor.from_local(local, debug_mesh, [Replicate(), Shard(0)],
                               run_check=False)
        tracker = D.step_mem_tracker()()
        tracker.track_external(local)
        with tracker, D.CostCounter() as cc:
            out = t.redistribute(debug_mesh, target)
        got = tuple(out.to_local().shape)
        peak = max(d["Total"] for d in
                   tracker.get_tracker_snapshot("peak").values())
    assert got == ((64, 32) if kind == "all-gather" else (64, 8))
    want = {k: 0 for k in RL.COLL_KINDS}
    want[kind] = 16 * 32 * 4
    assert cc.coll == want
    assert cc.flops == 0
    if kind == "all-to-all":
        assert peak == 2 * 16 * 32 * 4


def test_step_mem_tracker_sees_local_ops_only(debug_mesh):
    """The dry run's tracker holds a DTensor product at the local shards'
    bytes: DTensor infers the output at global sizes under a fake mode of
    its own, which the tracker passes untracked (some torch releases'
    own tracker counts it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m, k, n = 264, 520, 1032
    with compat.fake_safe_dtensor(), FakeTensorMode():
        xl = torch.empty((m // 2, k), dtype=torch.bfloat16)
        wl = torch.empty((k, n // 4), dtype=torch.bfloat16)
        x = DTensor.from_local(xl, debug_mesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(wl, debug_mesh, [Replicate(), Shard(1)],
                               run_check=False)
        tracker = D.step_mem_tracker()()
        tracker.track_external(xl, wl)
        with tracker:
            y = x @ w
        peak = max(d["Total"] for d in
                   tracker.get_tracker_snapshot("peak").values())
        assert tuple(y.to_local().shape) == (m // 2, n // 4)
    assert peak == 2 * ((m // 2) * k + k * (n // 4) + (m // 2) * (n // 4))


def _moe_padding_flops(cfg, tokens: int) -> float:
    """The grouped matmuls' rows past the routed ones: E x capacity rows
    (capacity factor 1.5, tiles of 128: `moe.moe_apply_sorted`) against
    T x topk assignments, 3 gated products of D x F a layer."""
    cap = -(-(int(tokens * cfg.topk * 1.5 / cfg.n_experts) + 1) // 128) * 128
    rows = cfg.n_experts * cap
    return 2 * (rows - tokens * cfg.topk) * cfg.d_model * cfg.d_ff * 3 * \
        cfg.n_layers


def test_fake_steps_reach_the_kernel_ops_and_count_the_analytic_flops():
    """A 2-layer full-width granite-moe prefill and train step (bf16,
    remat) on fake tensors, unsharded: every kernel op is reached as
    often as the real path calls it at that depth (phase 12's 48 / 216 /
    72 for 24 layers), and the counted FLOPs are `launch/flops.cell_flops`
    exactly once the model's known departures from it are added:
      * the MoE's grouped matmuls run over E x capacity padded rows, not
        T x topk (all four passes in training);
      * training recomputes attention's forward through the plain version
        for the backward (the reference's VJP): that and its backward are
        3 x the full S x S product, where the analytic model counts 2 x the
        causal pairs past the forward."""
    cfg = TC.get("granite-moe-1b-a400m").replace(n_layers=2)
    b, s = 2, 256
    hd, hq = cfg.resolved_head_dim, cfg.n_heads
    kept = 4 * b * hq * hd * FAK.kept_pairs(s, s, True, None) * cfg.n_layers
    square = 4 * b * hq * hd * s * s * cfg.n_layers
    pad = _moe_padding_flops(cfg, b * s)
    meta = torch.device("meta")
    pre = D.count_step(cfg, SHAPES.ShapeSpec("p", "prefill", s, b), None,
                       meta)
    fwd = FL.cell_flops(cfg, SHAPES.ShapeSpec("p", "prefill", s, b))
    assert pre.kernel_calls == {"flash_attention": 2, "grouped_matmul": 6}
    assert pre.flops == pytest.approx(fwd["total"] + pad, rel=1e-12)
    tr = D.count_step(cfg, SHAPES.ShapeSpec("t", "train", s, b), None, meta)
    assert tr.kernel_calls == {"flash_attention": 4, "grouped_matmul": 18,
                               "grouped_matmul_dw": 6}
    want = FL.cell_flops(cfg, SHAPES.ShapeSpec("t", "train", s, b),
                         remat=True)["total"] - 2 * kept + 3 * square + 4 * pad
    assert tr.flops == pytest.approx(want, rel=1e-12)
    assert 0 < pre.peak_bytes < tr.peak_bytes
    assert pre.coll == tr.coll == {k: 0.0 for k in RL.COLL_KINDS}


def test_fake_count_equals_the_real_steps_count(tmp_path):
    """The dry run's count of a fake step equals the same counter over the
    step run for real (`build_step`'s zero-filled trees): a reduced
    granite-moe's train step, prefill and decode step with their cell's
    sharding on a 1 x 1 mesh of a one-rank gloo group.  chip_smoke.py
    phase 17a holds the same on the card, through the kernels."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    cfg = TC.get("granite-moe-1b-a400m", reduced=True)
    n_p = D.n_params(D.param_meta(cfg))
    cpu = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        for shape in (SHAPES.ShapeSpec("t", "train", 64, 2),
                      SHAPES.ShapeSpec("p", "prefill", 64, 2),
                      SHAPES.ShapeSpec("d", "decode", 128, 2)):
            sc = D.cell_sharding(mesh, shape, n_p)
            with costmode.enable():
                fake = D.count_step(cfg, shape, sc, cpu, track_memory=False)
            call, _ = D.build_step(cfg, shape, sc, cpu)
            with costmode.enable(), D.CostCounter() as real:
                call()
            got = real.totals()
            assert (fake.flops, fake.bytes, fake.coll) == (
                got["flops"], got["bytes"], got["coll"]), shape.kind
            assert fake.flops > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch, seq", [("jamba-v0.1-52b", 512),
                                       ("xlstm-125m", 64)])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_costmode_counts_equal_the_full_loops(arch, seq, kind):
    """Under cost mode a recurrent mixer's time loop runs three trips
    counted as all (`costmode.loop`): mamba's chunk scan (4 chunks of 128
    here), the mLSTM's (4 of 16) and the sLSTM's 64 steps.  The step of
    one reduced body counts the FLOPs, bytes and kernel calls of the full
    loops, the backward's checkpointed recompute and gradient sums
    included."""
    cfg = TC.get(arch, reduced=True)
    cfg = cfg.replace(n_layers=cfg.block_pattern)
    shape = SHAPES.ShapeSpec("s", kind, seq, 1)
    cpu = torch.device("cpu")
    with costmode.enable():
        one = D.count_step(cfg, shape, None, cpu, track_memory=False)
    full = D.count_step(cfg, shape, None, cpu, track_memory=False)
    assert (one.flops, one.bytes, one.kernel_calls) == (
        full.flops, full.bytes, full.kernel_calls)
    assert full.flops > 0


# ---------------------------------------------------------------------------
# the CLI, the device policy, compat, costmode
# ---------------------------------------------------------------------------

def test_cli_on_a_debug_mesh(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    rc = D.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                 "--debug-mesh", "--device", "cpu", "--skip-full", "--out",
                 str(out)])
    assert rc == 0
    import json
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["arch"], rec["shape"], rec["chips"]) == ("xlstm-125m",
                                                          "decode_32k", 8)
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["counted_flops_per_chip"] > 0 and rec["coll_bytes_per_chip"] > 0
    assert rec["n_params"] == D.n_params(D.param_meta(TC.get("xlstm-125m")))
    assert rec["hardware"] == "H100 SXM5" and rec["kernel_calls"] == {}
    assert "dry-run summary: 1 ok, 0 skipped (noted), 0 errors" in \
        capsys.readouterr().out
    # a second run measures the cell again and writes a new file
    assert D.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                   "--debug-mesh", "--device", "cpu", "--skip-full",
                   "--no-cost", "--out", str(out)]) == 0
    assert "[run]" in capsys.readouterr().out
    (rec,) = json.loads(out.read_text())
    assert "counted_flops_per_chip" not in rec


def test_device_policy(monkeypatch, tmp_path):
    """The default device is the card: without one the dry run raises, as
    every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            D.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                    "--out", str(tmp_path / "x.json"), *argv])
    assert not (tmp_path / "x.json").exists()


def test_compat_raises_for_a_missing_name(monkeypatch):
    monkeypatch.setitem(compat._WHERE, "NoSuchName", ("torch.utils",
                                                      "no.such.module"))
    with pytest.raises(ImportError, match=re.escape(torch.__version__)):
        compat.NoSuchName
    with pytest.raises(AttributeError):
        compat.not_a_compat_name
    assert compat.register_flop_formula is compat.lookup(
        "register_flop_formula")


def test_costmode_and_baseline_toggles():
    from repro_torch.models import moe as MOE
    assert not costmode.enabled()
    with costmode.enable():
        assert costmode.enabled()
    assert not costmode.enabled()
    assert MOE.TOKEN_SHARDED_DEFAULT is True
    with D._baseline(True):
        assert MOE.TOKEN_SHARDED_DEFAULT is False
    assert MOE.TOKEN_SHARDED_DEFAULT is True
    assert math.isclose(RL.H100["sxm"].tf32_flops, 494.7e12)
