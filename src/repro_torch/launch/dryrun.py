"""Multi-pod dry run (deliverable e) — the port of the reference's
`launch/dryrun.py`: every (architecture x input shape x mesh) cell's step
runs on fake tensors over a fake 256-rank (16 x 16) or 512-rank
(2 x 16 x 16) mesh, and the ops it dispatches are counted.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k [--multi-pod] [--out build/dryrun.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
      --shape decode_32k --debug-mesh --device cpu

The reference's flags, plus `--device {cuda,cpu}` (default cuda: fake
CUDA tensors on a "cuda" mesh, through the kernel ops' fake
implementations; it raises without a card, as every entry point of the
port does; "cpu" takes the kernels' plain versions on a "cpu" mesh).

A cell runs rank 0 of a world of the mesh's size on the "fake" process-
group backend (`compat.FakeStore`: collectives move nothing).  No weight
is allocated: the parameters are fake tensors of the init's shapes
(`param_meta`: the init run under `FakeTensorMode`), placed by
`sharding.params_shardings` with the reference's `ShardingConfig` flags;
the step is the port's `make_train_step` / `make_prefill_step` /
`make_decode_step`, run under `FakeTensorMode`.  `CostCounter` counts,
from the local (per-rank) ops only — an op on DTensors is left to
DTensor, which dispatches the local ops it stands for, so nothing is
counted twice:

  * FLOPs, by `torch.utils.flop_counter`'s formulas (the matmul family
    and the `repro_torch::` kernel ops);
  * bytes: each operand read once and each output written once; views
    and aliases move none; collectives count only as collective bytes;
  * collective bytes by the reference's five kinds: the operand a rank
    puts on the wire, from the functional collectives and the `c10d`
    ops the step dispatches;
  * calls of each `repro_torch::` kernel op.

`compat.MemTracker`, over the step's own ops (`step_mem_tracker`), gives
the peak bytes on the step's device.  As in the reference, a cell runs
at full depth (it proves the cell fits: `fits` compares that peak with
`H100_BYTES`, on the card and on the CPU alike) and at 1 and 2 bodies,
combined by `roofline.extrapolate`.  All three run under `costmode`: a
recurrent mixer's time loop runs three trips, counted as all of them
(the peak then misses the other trips' outputs, which the loop keeps
until it stacks them).  The record keeps the
reference's keys where they mean the same; the HLO-derived ones are
renamed for what is counted (`counted_flops_per_chip`,
`counted_bytes_per_chip`, `counted_vs_analytic`).  A cell that raises
gets `status: "error"` and the run exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time
import traceback
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline as RL

DEFAULT_OUT = os.path.join("build", "dryrun.json")
H100_BYTES = 80e9        # the memory `fits` holds a peak to, on any device:
                         # an H100's 80 GB (the card's total_memory, 85.5e9
                         # B on the 80GB HBM3 part, also holds the CUDA
                         # context and the allocator's slack)

LM_ARCHS = [
    "gemma2-2b", "granite-34b", "qwen1.5-4b", "qwen1.5-32b",
    "jamba-v0.1-52b", "xlstm-125m", "seamless-m4t-medium",
    "granite-moe-1b-a400m", "mixtral-8x7b", "qwen2-vl-72b",
]
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None,
                   choices=[None, *ALL_SHAPES])
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--debug-mesh", action="store_true",
                   help="tiny 8-rank mesh (2 x 4, or 2 x 2 x 2)")
    p.add_argument("--skip-full", action="store_true",
                   help="skip the full-depth run (cost terms only)")
    p.add_argument("--no-cost", action="store_true",
                   help="full-depth run only (no depth-1/2 runs)")
    p.add_argument("--fsdp-min-params", type=float, default=3e9,
                   help="enable FSDP above this param count")
    p.add_argument("--grad-bf16", action="store_true",
                   help="cast grads to bf16 before the DP reduction")
    p.add_argument("--no-sp", action="store_true",
                   help="disable Megatron-SP boundary sharding")
    p.add_argument("--baseline", action="store_true",
                   help="the reference's baseline: no decode-cache "
                        "sharding over 'model', no token-sharded EP (the "
                        "pinned embedding lookup is the port's only one)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="fake CUDA tensors through the kernel ops "
                        "(default; needs a card), or the plain versions "
                        "on fake CPU tensors")
    return p


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------

def _leaves(tree):
    from repro_torch.models.params import flatten_tree
    return [leaf for _, leaf in flatten_tree(tree)]


def n_params(tree) -> int:
    return sum(leaf.numel() for leaf in _leaves(tree))


def n_active_params(cfg, tree):
    """6*N_active*D accounting: MoE experts scaled by topk/E."""
    from repro_torch.distributed import sharding as SH
    total, expert = 0, 0

    def walk(path, leaf):
        nonlocal total, expert
        total += leaf.numel()
        if path and path[-1] in ("w_in", "w_gate", "w_out"):
            expert += leaf.numel()
        return leaf
    SH.tree_map_with_path(walk, tree)
    if cfg.n_experts:
        return total - expert + expert * cfg.topk / cfg.n_experts
    return total


def device_bytes(tree, specs, mesh) -> float:
    """Analytic per-device bytes of a tree placed by a tree of specs."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.params import tree_map
    axes = SH.mesh_axes(mesh)
    parts = []

    def one(leaf, spec):
        div = math.prod(axes[a] for e in spec for a in SH.axis_names(e))
        parts.append(leaf.numel() * leaf.element_size() / div)
        return leaf
    tree_map(one, tree, specs)
    return float(sum(parts))


@functools.lru_cache(maxsize=8)
def param_meta(cfg):
    """The init's parameter tree as meta tensors (float32, the init's
    dtype): the init runs under `FakeTensorMode` on the CPU, so nothing
    is drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    with FakeTensorMode():
        fake = registry.build(cfg).init(torch.Generator(), torch.float32,
                                        device="cpu").tree()
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), fake)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

# collective op -> (kind, index of the operand a rank puts on the wire)
COLLECTIVES = {
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_c10d_functional_autograd::all_to_all_single": ("all-to-all", 0),
    "_c10d_functional_autograd::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional_autograd::reduce_scatter_tensor":
        ("reduce-scatter", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
    # DTensor's Shard(i) -> Shard(j) on a CUDA mesh (a CPU mesh all-gathers)
    "_dtensor::shard_dim_alltoall": ("all-to-all", 0),
}
# communication ops that put nothing on the wire themselves
NOT_COLLECTIVES = {"_c10d_functional::wait_tensor", "c10d::recv_",
                   "c10d::barrier", "c10d::monitored_barrier_"}
# ops that make or alias a tensor without moving its bytes
NO_BYTES = {"aten::detach", "aten::alias", "aten::lift_fresh",
            "aten::_unsafe_view", "aten::empty", "aten::empty_like",
            "aten::empty_strided", "aten::new_empty",
            "aten::new_empty_strided", "aten::_local_scalar_dense",
            "prim::device", "prim::layout"}


def _tensors(tree):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """A dispatch mode that counts FLOPs, bytes, collective bytes by kind
    and `repro_torch::` kernel-op calls from the local ops of a step (see
    the module docstring).  Works on fake and real tensors alike."""

    def __init__(self):
        super().__init__()
        from repro_torch import compat, costmode
        self._weight = costmode.weight
        self._formulas = compat.flop_registry
        self._active_fake_mode = compat.active_fake_mode
        self._entry_mode = None
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in RL.COLL_KINDS}
        self.kernel_calls: dict = {}

    def __enter__(self):
        self._entry_mode = self._active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor infers output shapes at global sizes under a fake mode of
        # its own (once an op signature, then cached): not the step's work
        # (an op of a loop trip that stands for several counts as many)
        w = self._weight()
        if w and self._active_fake_mode() is self._entry_mode:
            self._count(func, args, kwargs, out, self._formulas, w)
        return out

    def _count(self, func, args, kwargs, out, registry, w: int = 1):
        name = func._schema.name
        if name in COLLECTIVES:
            kind, i = COLLECTIVES[name]
            self.coll[kind] += w * sum(_nbytes(t) for t in _tensors(args[i]))
            return
        ns = name.split("::", 1)[0]
        if ns in ("c10d", "_c10d_functional", "_c10d_functional_autograd"):
            if name not in NOT_COLLECTIVES:
                raise KeyError(f"{name}: a collective the dry run does not "
                               "count")
            return
        if ns == "repro_torch":
            op = name.split("::", 1)[1]
            self.kernel_calls[op] = self.kernel_calls.get(op, 0) + w
        formula = registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += w * int(formula(*args, **kwargs, out_val=out))
        if func.is_view or name in NO_BYTES:
            return
        outs = {id(t): t for t in _tensors(out)}
        ins = {id(t): t for t in _tensors((args, kwargs)) if id(t) not in outs}
        self.bytes += w * (sum(_nbytes(t) for t in ins.values()) +
                           sum(_nbytes(t) for t in outs.values()))

    def totals(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": {k: float(v) for k, v in self.coll.items()},
                "kernel_calls": dict(sorted(self.kernel_calls.items()))}


@functools.lru_cache(maxsize=1)
def step_mem_tracker():
    """`compat.MemTracker` tracking the step's own ops only: an op run
    under another fake mode than the one the tracker was entered under
    (DTensor's shape inference, at global sizes) passes untracked.  Newer
    releases' tracker does this itself; the card's torch 2.11 counted
    those ops, 38 GB of qwen2-vl-72b's train_4k peak a device."""
    from repro_torch import compat

    class StepMemTracker(compat.MemTracker):
        def __enter__(self):
            self._step_mode = compat.active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            if compat.active_fake_mode() is not self._step_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return StepMemTracker


class StepCount(NamedTuple):
    flops: float
    bytes: float
    coll: dict
    kernel_calls: dict
    peak_bytes: int
    seconds: float


def _local(x):
    from repro_torch.distributed import sharding as SH
    return x.to_local() if SH.is_dtensor(x) else x


def build_step(cfg, shape, sc, device, grad_bf16: bool = False):
    """(call, held): the cell's step as a no-argument callable on fake
    tensors placed on `sc.mesh` (or unsharded when `sc` is None), and the
    tensors it holds before it runs (parameters, optimizer state, decode
    states, batch).  Call it inside the `FakeTensorMode` it was built
    under."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.shapes import decode_state_specs, input_specs
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    from repro_torch.serve.lm import (ServeConfig, make_decode_step,
                                      make_prefill_step)
    from repro_torch.train import optim as OPT
    from repro_torch.train.step import TrainConfig, make_train_step

    model = registry.build(cfg)

    def fake(meta, dtype=None):
        return tree_map(lambda m: torch.zeros(
            m.shape, dtype=dtype or m.dtype, device=device), meta)

    def place(tree, specs):
        return tree if sc is None else SH.distribute(tree, specs, sc.mesh)

    meta = param_meta(cfg)
    batch = fake(input_specs(cfg, shape))
    if shape.kind == "train":
        params = place(fake(meta), SH.params_shardings(meta, sc)
                       if sc is not None else None)
        opt = OPT.init(params)
        tc = TrainConfig(grad_reduce_dtype=torch.bfloat16 if grad_bf16
                         else None)
        step = make_train_step(model, tc, OPT.AdamWConfig(), sc)
        return (lambda: step(params, opt, batch)), (params, opt, batch)
    params = place(fake(meta, torch.bfloat16), SH.params_shardings(meta, sc)
                   if sc is not None else None)
    svc = ServeConfig(max_len=shape.seq)
    if shape.kind == "prefill":
        step = make_prefill_step(model, svc, sc)
        return (lambda: step(params, batch)), (params, batch)
    states_meta = decode_state_specs(model, cfg, shape)
    states = place(fake(states_meta), SH.state_specs(states_meta, sc)
                   if sc is not None else None)
    step = make_decode_step(model, svc, sc)
    return (lambda: step(params, states, batch)), (params, states, batch)


def count_step(cfg, shape, sc, device, grad_bf16: bool = False,
               track_memory: bool = True) -> StepCount:
    """Run the cell's step once on fake tensors and count it (see the
    module docstring); `sc` None runs it unsharded."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import compat
    t0 = time.perf_counter()
    param_meta(cfg)       # the init's own fake mode runs outside this one
    with compat.fake_safe_dtensor(), FakeTensorMode():
        call, held = build_step(cfg, shape, sc, device, grad_bf16)
        tracker = None
        if track_memory:
            tracker = step_mem_tracker()()
            tracker.track_external(*[_local(t) for t in _tensors(held)])
        counter = CostCounter()
        with contextlib.ExitStack() as stack:
            if tracker is not None:
                stack.enter_context(tracker)
            stack.enter_context(counter)
            call()
        peak = 0
        if tracker is not None:
            # the step's device: a host tensor is no device memory
            peak = max((d.get("Total", 0) for dev, d in
                        tracker.get_tracker_snapshot("peak").items()
                        if torch.device(dev).type == device.type),
                       default=0)
    got = counter.totals()
    return StepCount(got["flops"], got["bytes"], got["coll"],
                     got["kernel_calls"], int(peak),
                     time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """A process group of `world` ranks on the "fake" backend, this process
    rank 0; destroyed on exit.  Raises if a group is already initialised
    (one process group at a time)."""
    import torch.distributed as dist

    from repro_torch import compat
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry "
                           "run makes its own fake one")
    dist.init_process_group("fake", store=compat.FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_of(multi_pod: bool, debug: bool, device_type: str):
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    make = make_debug_mesh if debug else make_production_mesh
    return make(multi_pod=multi_pod, device_type=device_type)


def mesh_world(multi_pod: bool, debug: bool) -> int:
    if debug:
        return 8
    return 512 if multi_pod else 256


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_sharding(mesh, shape, n_params_: int, fsdp_min_params: float = 3e9,
                  no_sp: bool = False, baseline: bool = False):
    """The reference's `ShardingConfig` of a cell: FSDP for a train step
    above `fsdp_min_params` parameters, Megatron-SP boundaries off for
    decode, the decode cache's sequence over the data axes, and over
    "model" too unless `baseline`."""
    from repro_torch.distributed import sharding as SH
    return SH.ShardingConfig(
        mesh,
        fsdp=(n_params_ > fsdp_min_params and shape.kind == "train"),
        seq_parallel=(shape.kind != "decode" and not no_sp),
        shard_seq_over_data=(shape.kind == "decode"),
        kv_seq_over_model=not baseline)


def run_cell(args, arch: str, shape_name: str, multi_pod: bool, mesh,
             device, hw: RL.Hardware, capacity: float) -> dict:
    from repro_torch import configs, costmode
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import flops as FL
    from repro_torch.launch.shapes import SHAPES, cell_supported

    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = cell_supported(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec

    chips = math.prod(SH.mesh_axes(mesh).values())
    t0 = time.time()
    try:
        meta = param_meta(cfg)
        n_p = n_params(meta)
        sc = cell_sharding(mesh, shape, n_p, args.fsdp_min_params,
                           args.no_sp, args.baseline)
        info = {"n_params": n_p,
                "n_active_params": n_active_params(cfg, meta),
                "param_bytes_per_device": device_bytes(
                    meta, SH.params_shardings(meta, sc), mesh)}
        rec.update(device=device.type, hardware=hw.name)
        # ---- full depth: the cell's step fits -------------------------
        if not args.skip_full:
            with costmode.enable():
                full = count_step(cfg, shape, sc, device, args.grad_bf16)
            rec.update(peak_bytes_per_device=full.peak_bytes,
                       capacity_bytes=capacity,
                       fits=full.peak_bytes <= capacity,
                       full={"counted_flops_per_chip": full.flops,
                             "counted_bytes_per_chip": full.bytes,
                             "coll_bytes_per_chip": sum(full.coll.values()),
                             "kernel_calls": full.kernel_calls,
                             "s": round(full.seconds, 1)})
        if args.no_cost:
            rec.update(status="ok", chips=chips, n_params=info["n_params"],
                       total_s=round(time.time() - t0, 1))
            return rec

        # ---- depth 1 and 2, extrapolated ------------------------------
        n_bodies = max(1, cfg.n_layers // cfg.block_pattern)
        counts = []
        for k in (1, 2):
            ckw = {"n_layers": cfg.block_pattern * k}
            if cfg.encoder_layers:
                ckw["encoder_layers"] = k
            with costmode.enable():
                counts.append(count_step(cfg.replace(**ckw), shape, sc,
                                         device, args.grad_bf16,
                                         track_memory=False))
        c1, c2 = counts
        cell = RL.extrapolate({"flops": c1.flops, "bytes": c1.bytes},
                              {"flops": c2.flops, "bytes": c2.bytes},
                              c1.coll, c2.coll, n_bodies)
        calls = {op: c1.kernel_calls.get(op, 0) + (n_bodies - 1) * max(
            0, c2.kernel_calls.get(op, 0) - c1.kernel_calls.get(op, 0))
            for op in sorted(set(c1.kernel_calls) | set(c2.kernel_calls))}
        af = FL.cell_flops(cfg, shape, remat=(shape.kind == "train"))
        mf = RL.model_flops(cfg, shape, info["n_active_params"])
        terms = cell.terms(af["total"] / chips, hw)
        dominant = max(terms, key=terms.get)
        rec.update(
            status="ok",
            chips=chips,
            n_params=info["n_params"],
            n_active_params=info["n_active_params"],
            param_bytes_per_device=round(info["param_bytes_per_device"]),
            analytic_flops=af["total"],
            counted_flops_per_chip=cell.flops,
            counted_bytes_per_chip=cell.hbm_bytes,
            coll_bytes_per_chip=cell.coll_bytes_per_chip,
            coll_by_kind=cell.coll_by_kind,
            kernel_calls=calls,
            **{k: float(f"{v:.6g}") for k, v in terms.items()},
            dominant=dominant.replace("_s", ""),
            model_flops=mf,
            useful_flops_ratio=float(f"{mf / max(af['total'], 1):.4g}"),
            counted_vs_analytic=float(
                f"{cell.flops * chips / max(af['total'], 1):.4g}"),
            total_s=round(time.time() - t0, 1),
        )
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   total_s=round(time.time() - t0, 1))
    return rec


@contextlib.contextmanager
def _baseline(on: bool):
    """The reference's `--baseline` toggle, restored on exit: the
    replicated-token EP dispatch.  (Its other toggle, the pinned embedding
    lookup, is the port's only lookup of a vocab-sharded table:
    `nn.embed`.)"""
    from repro_torch.models import moe as MOE
    saved = MOE.TOKEN_SHARDED_DEFAULT
    if on:
        MOE.TOKEN_SHARDED_DEFAULT = False
    try:
        yield
    finally:
        MOE.TOKEN_SHARDED_DEFAULT = saved


def main(argv=None) -> int:
    args = _build_argparser().parse_args(argv)
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    hw = RL.hardware(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None)
    capacity = H100_BYTES

    archs = [args.arch] if args.arch else LM_ARCHS
    shapes = [args.shape] if args.shape else ALL_SHAPES
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    with _baseline(args.baseline):
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            with fake_world(mesh_world(mp, args.debug_mesh)):
                mesh = mesh_of(mp, args.debug_mesh, device.type)
                for arch in archs:
                    for shape_name in shapes:
                        print(f"[run] {(arch, shape_name, mesh_name)}",
                              flush=True)
                        rec = run_cell(args, arch, shape_name, mp, mesh,
                                       device, hw, capacity)
                        print(json.dumps({k: v for k, v in rec.items()
                                          if k != "traceback"}), flush=True)
                        if "traceback" in rec:
                            print(rec["traceback"], file=sys.stderr,
                                  flush=True)
                        results.append(rec)
                        with open(args.out, "w") as f:
                            json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_err = sum(1 for r in results if r.get("status") == "error")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (noted), "
          f"{n_err} errors -> {args.out}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
