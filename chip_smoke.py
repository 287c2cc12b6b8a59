#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # one card; exits non-zero without one
    python3 chip_smoke.py --profile  # also print a torch.profiler breakdown

Phases (any failure exits non-zero; none catches its own):

  1. device: the card's name and power limit (nvidia-smi).
  2. build: every `csrc/*.cu` of `repro_torch` with nvcc for sm_90a.
  3. kernels: one full-width MinkUNet forward (plain torch flow "fod") on a
     50k-point city scene in the 65536 bucket records the inputs of all 41
     sparse convs.  Each kernel is held against its plain PyTorch version
     on those inputs (atol = rtol = 1e-4: float32 sums in another order)
     and timed with CUDA events beside the plain version, a GEMM-only
     yardstick (an einsum over pre-gathered rows; not used by the port)
     and its bound: the larger of (bytes / memory rate) and (FLOPs /
     float32 non-tensor peak), counting only this run's non-empty inverse
     entries (2 * nnz * Cin * Cout FLOPs) and the feature rows they
     reference.
  4. main path: `PointCloudEngine(flow="cuda_fused").segment` serves five
     requests (scene A, scene B, A, B, A: two misses, then mapping-cache
     hits), then one `flow="cuda"` request runs the baseline kernel.  The
     launch counts are zeroed just before and read just after; the fused
     kernel must launch 41 times per request.  Labels are checked against
     the "fod" logits on valid rows: a mismatch is allowed only where the
     top-2 logit gap is below the tolerance.
  5. point kernels: one plain full-width PointNet++(s) forward (13
     classes, B = 16 clouds of N = 4096 points from `dense_xyz_batch`, the
     last cloud masked to 3000 valid points) and one plain full-width
     PointNet forward (40 classes, B = 8 x 1024) record the input of every
     fused-MLP group.  The point models' weights are the reference's init
     from `torch.Generator().manual_seed(seed)` scaled to He's gain, with
     biases uniform in +-0.1 (`smoke_weights`), so activations and logits
     stay O(1).  The kernel is held against its plain version on each
     group: max|kernel - plain| <= 1e-5 * max|plain| (float32 sums in
     another order), with the rms and max of the plain output printed.  It
     is timed beside the plain version and a layer-by-layer cuBLAS
     yardstick (`torch.addmm` + `relu_`, TF32 off; not used by the port),
     each as the device time of one call (20 calls captured in a CUDA
     graph, replayed between CUDA events), and given its bound: the larger
     of (x read + output written + weights and biases once) / memory rate
     and 2 * rows * sum(Cin * Cout) / float32 peak.
  6. point path: PointNet++(s) at full width on that batch, initialised
     on the card; one warm-up and three timed forwards (host clock around
     synchronised calls).  The launch count is zeroed just before and read
     just after: the kernel must launch once per planned group (6) each
     forward.  Logits are held against the plain forward with the same
     relative rule, and labels on valid points must be equal except where
     the plain top-2 gap is below 1e-5 * max|plain logit|.  Negative
     controls: the same check must reject the forward with any one group
     written as zeros, and with the head's output off by a relative 1e-4.
  7. the other five models (PointNet, PointNet++(c) at n1 = 512, n2 = 128,
     PointNet++(ps), DGCNN at k = 20, F-PointNet++), width 1, B = 8 x 1024:
     one forward each through the kernel (launches = planned groups) and
     one plain, checked the same way (F-PointNet++'s centre and box too).
  8. a {"kernels": [...]} line, the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.

`--profile` adds torch.profiler tables of one segment request and of one
PointNet++(s) forward, split into FPS, ball query, kNN, gathers and
fused-MLP groups, with the forward's device time and that of the
`fused_mlp_kernel` rows.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                 # atol = rtol: float32 summation-order differences
SCENE_A = (11, 50000)      # city_scene(seed, n_points): 65536 bucket
SCENE_B = (12, 40000)
N_STAGES = 4
REPS = 10
NAMED = {  # the shapes the kernel phase must cover, by site
    "stem": "stem, Cin=4",
    "enc3.b0.conv1": "level-4 encoder, Cin=Cout=256",
    "dec3.b0.conv1": "level-0 decoder conv1, 128->96",
    "dec3.b0.conv2": "level-0 decoder conv2, 96->96 + residual",
}
PN_BATCH = (0, 0, 16, 4096)   # dense_xyz_batch(seed, step, B, N): PointNet++(s)
PN_LAST_VALID = 3000          # valid points of the last cloud
OTHER_BATCH = (1, 0, 8, 1024)  # the other five models
OTHER_LAST_VALID = 700
MLP_REPS = 20              # calls captured in one CUDA graph (point kernels)
GRAPH_REPLAYS = 5
REL_TOL = 1e-5  # point path: max|got - want| <= REL_TOL * max|want|
PEAKS = {  # (bytes/s, float32 non-tensor FLOP/s), NVIDIA data sheets
    "sxm": (3.35e12, 67e12),
    "pcie": (2.0e12, 51e12),
}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms of one `fn()` call: `reps` calls captured in one CUDA graph,
    the graph replayed GRAPH_REPLAYS times between two CUDA events, so
    the wrapper's host work (operand checks, ctypes, allocation) is not
    in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()      # warm-up outside the graph (cuBLAS handles, attributes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * GRAPH_REPLAYS)


def smoke_weights(model, gen):
    """The smoke's point models: the reference's init scaled to He's gain
    (uniform +-sqrt(6 / fan_in)) with biases uniform in +-0.1 from `gen`,
    so that activations and logits stay O(1) through every layer and the
    relative checks below see real values, not a decayed signal."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w"):
                p.mul_(6.0 ** 0.5)
            else:
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * 0.1)
    return model


def rel_close(got, want) -> tuple[bool, float, float]:
    """The point path's rule: shapes equal, `got` finite, max|want| > 0
    and max|got - want| <= REL_TOL * max|want|.  Returns (ok, max abs
    error, max|want|)."""
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return False, float("inf"), float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.abs().max())
    return scale > 0 and err <= REL_TOL * scale, err, scale


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def planned_launches(tree) -> int:
    """Fused-MLP launches of one forward: one per group of the port's plan,
    over every MLP chain ({"fc0": ..., "fc1": ...}) of a model tree."""
    from repro_torch.core.fusion import plan_fusion
    if all(k.startswith("fc") for k in tree):
        ws = [tree[f"fc{i}"]["w"] for i in range(len(tree))]
        return len(plan_fusion([ws[0].shape[0]] + [w.shape[1] for w in ws]))
    return sum(planned_launches(v) for v in tree.values())


@contextlib.contextmanager
def mlp_groups_through(fn):
    """Run every group of `fused_mlp_chain` through `fn(x, ws, bs,
    final_act=...)` instead of the kernel: the plain path, for checks."""
    from repro_torch.kernels.fused_mlp import ops
    saved = ops.fused_mlp
    ops.fused_mlp = fn
    try:
        yield
    finally:
        ops.fused_mlp = saved


def plain_groups(record=None):
    """The plain fused-MLP version as a group function; appends each
    group's operands to `record` when given."""
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref

    def fn(x, ws, bs, *, final_act=True):
        if record is not None:
            record.append((x.contiguous(), list(ws), list(bs), final_act))
        return fused_mlp_ref(x, ws, bs, final_act)
    return fn


def cublas_chain(x, ws, bs, final_act):
    """Layer by layer through cuBLAS: the yardstick beside the kernel."""
    import torch
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = torch.addmm(b, h, w)
        if i < len(ws) - 1 or final_act:
            h.relu_()
    return h


def labels_agree(got, want, valid) -> tuple[bool, str]:
    """The point path's output check against the plain forward `want`:
    logits within `rel_close`, and argmax labels equal on `valid` rows
    except where `want`'s top-2 gap is below REL_TOL * max|want|."""
    ok, err, scale = rel_close(got, want)
    n_valid = int(valid.sum())
    if got.shape != want.shape:
        return False, f"logits {tuple(got.shape)} != {tuple(want.shape)}"
    top2 = want.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    diff = (got.argmax(-1) != want.argmax(-1)) & valid
    close = diff & (gap < REL_TOL * scale)
    ok = ok and not int((diff & ~close).sum())
    return ok, (f"logits max abs err {err:.2e}, max|plain| {scale:.3g}, "
                f"rms plain {rms(want):.3g}; labels: {int(diff.sum())} of "
                f"{n_valid} valid differ, {int(close.sum())} of them within "
                f"a top-2 gap < {REL_TOL:g} * max|plain|")


def check_labels(label, got, want, valid):
    ok, msg = labels_agree(got, want, valid)
    print(f"{label} vs plain: {msg}")
    if not ok:
        raise AssertionError(f"{label}: output differs from the plain path "
                             "beyond the tolerance")


def site_names(tree) -> list[str]:
    """Conv sites in `minkunet_forward` order."""
    names = ["stem"]
    for side, (stages, first) in (("enc", (tree["enc"], "down")),
                                  ("dec", (tree["dec"], "up"))):
        for i, st in enumerate(stages):
            names.append(f"{side}{i}.{first}")
            for b in range(len(st["blocks"])):
                names += [f"{side}{i}.b{b}.conv1", f"{side}{i}.b{b}.conv2"]
    return names


def point_phases(dev, mem_rate: float, flop_rate: float,
                 with_profile: bool):
    """Phases 5-7 (see the module docstring).  Returns the main-path
    fused-MLP launch counts and the kernel phase's PointNet++(s) totals."""
    import torch
    from repro_torch.data.synthetic import dense_xyz_batch
    from repro_torch.kernels.fused_mlp import fused_mlp as FK
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.models import pointnets as PN

    def cloud_batch(spec, last_valid):
        xyz, pmask, _ = dense_xyz_batch(*spec)
        pmask[-1, last_valid:] = False
        return (torch.from_numpy(xyz).to(dev), torch.from_numpy(pmask).to(dev))

    def model(init, seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return smoke_weights(getattr(PN, init)(gen, device=dev, **kw), gen)

    # 5. point kernels, on the input of every fused-MLP group of one plain
    # PointNet++(s) forward and one plain PointNet forward
    xyz, pmask = cloud_batch(PN_BATCH, PN_LAST_VALID)
    seg = model("pointnetpp_seg_init", 0, n_classes=13)
    seg_groups, pn_groups = [], []
    with mlp_groups_through(plain_groups(seg_groups)):
        seg_plain = seg(xyz, pmask)
    per_forward = planned_launches(seg.tree())
    if not len(seg_groups) == per_forward == 6:
        raise AssertionError(f"PointNet++(s): {len(seg_groups)} groups "
                             f"recorded, {per_forward} planned; expected 6")
    oxyz, omask = cloud_batch(OTHER_BATCH, OTHER_LAST_VALID)
    pointnet = model("pointnet_init", 1, n_classes=40)
    with mlp_groups_through(plain_groups(pn_groups)):
        pointnet_plain = pointnet(oxyz, omask)

    print(f"fused_mlp kernel phase: every group of one PointNet++(s) "
          f"forward {PN_BATCH[2]}x{PN_BATCH[3]} and one PointNet forward "
          f"{OTHER_BATCH[2]}x{OTHER_BATCH[3]}; rule max|kernel - plain| <= "
          f"{REL_TOL:g} * max|plain|; ms = device time a call ({MLP_REPS} "
          f"calls in one CUDA graph, {GRAPH_REPLAYS} replays, CUDA events)")
    print(f"{'group':12s} {'rows':>7s} {'widths':24s} {'tile':>4s} "
          f"{'split':>5s} {'smem':>6s} {'rms':>8s} {'max':>8s} "
          f"{'err':>9s} {'kernel':>8s} {'plain':>8s} {'cublas':>8s} "
          f"{'bound':>8s} {'by':>5s}")
    mlp = {"ms": 0.0, "plain": 0.0, "cublas": 0.0, "bound": 0.0,
           "bytes": 0.0, "ops": 0.0, "err": 0.0}
    seg_names = ["sa1", "sa2", "fp2.g0", "fp2.g1", "fp1", "head"]
    pn_names = [f"pointnet.{i}" for i in range(len(pn_groups))]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for gname, (gx, ws, bs, fa) in zip(seg_names + pn_names,
                                       seg_groups + pn_groups):
        got = FK.fused_mlp_cuda(gx, ws, bs, fa)
        want = fused_mlp_ref(gx, ws, bs, fa)
        ok, err, scale = rel_close(got, want)
        if not ok:
            raise AssertionError(
                f"fused_mlp kernel disagrees with its plain version at "
                f"{gname}: max abs err {err} against max|plain| {scale}")
        rows = gx.shape[0]
        widths = [gx.shape[1]] + [w.shape[1] for w in ws]
        nbytes = 4 * (rows * (widths[0] + widths[-1])
                      + sum(w.numel() + b.numel() for w, b in zip(ws, bs)))
        flops = 2.0 * rows * sum(a * b for a, b in zip(widths, widths[1:]))
        b_bytes, b_ops = nbytes / mem_rate * 1e3, flops / flop_rate * 1e3
        t = {"ms": graph_ms(lambda: FK.fused_mlp_cuda(gx, ws, bs, fa),
                            MLP_REPS),
             "plain": graph_ms(lambda: fused_mlp_ref(gx, ws, bs, fa),
                               MLP_REPS),
             "cublas": graph_ms(lambda: cublas_chain(gx, ws, bs, fa),
                                MLP_REPS)}
        bound = max(b_bytes, b_ops)
        if gname in seg_names:
            for key in t:
                mlp[key] += t[key]
            mlp["bound"] += bound
            mlp["bytes"] += b_bytes
            mlp["ops"] += b_ops
        mlp["err"] = max(mlp["err"], err)
        tile = FK.row_tile(widths, rows, n_sms)
        print(f"{gname:12s} {rows:7d} {str(widths):24s} {tile:4d} "
              f"{FK.col_splits(widths, rows, tile, n_sms):5d} "
              f"{FK.smem_bytes(widths, tile):6d} {rms(want):8.3g} "
              f"{scale:8.3g} {err:9.2e} {t['ms']:8.4f} {t['plain']:8.4f} "
              f"{t['cublas']:8.4f} {bound:8.4f} "
              f"{'ops' if b_ops >= b_bytes else 'bytes':>5s}")
    print(f"PointNet++(s) forward, 6 groups: kernel {mlp['ms']:.4f} ms, "
          f"plain {mlp['plain']:.4f} ms, cuBLAS layer by layer "
          f"{mlp['cublas']:.4f} ms, bound {mlp['bound']:.4f} ms (bytes "
          f"{mlp['bytes']:.4f}, ops {mlp['ops']:.4f})")

    # 6. point path: PointNet++(s) through the kernel
    FK.reset_launch_counts()
    seg_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_logits = seg(xyz, pmask)
        torch.cuda.synchronize()
        seg_ms.append((time.perf_counter() - t0) * 1e3)
    point_launches = dict(FK.LAUNCHES)
    if point_launches["fused_mlp"] != 4 * per_forward:
        raise AssertionError(f"fused_mlp launches {point_launches}, expected "
                             f"{per_forward} per forward")
    n_pts = PN_BATCH[2] * PN_BATCH[3]
    seg_median = statistics.median(seg_ms[1:])
    print(f"PointNet++(s) forward {PN_BATCH[2]}x{PN_BATCH[3]}: warm-up "
          f"{seg_ms[0]:.2f} ms, timed {[round(v, 2) for v in seg_ms[1:]]} "
          f"ms, median {seg_median:.2f} ms, {n_pts / seg_median * 1e3:.0f} "
          f"points/s; fused_mlp launches {point_launches['fused_mlp']} "
          f"({per_forward} per forward)")
    if seg_logits.shape != (PN_BATCH[2], PN_BATCH[3], 13):
        raise AssertionError(f"PointNet++(s) logits {seg_logits.shape}")
    check_labels("PointNet++(s)", seg_logits, seg_plain, pmask)

    # negative controls: the same check must reject a forward in which one
    # group is wrong (each group in turn written as zeros; the head off by
    # a relative 1e-4)
    def broken(bad_group, corrupt):
        calls = []

        def fn(x, ws, bs, *, final_act=True):
            out = fused_mlp_ref(x, ws, bs, final_act)
            calls.append(len(calls))
            return corrupt(out) if calls[-1] == bad_group else out
        return fn
    controls = [(f"{g} written as zeros", i, torch.zeros_like)
                for i, g in enumerate(seg_names)]
    controls.append(("head times (1 + 1e-4)", 5, lambda o: o * (1 + 1e-4)))
    for what, gi, corrupt in controls:
        with mlp_groups_through(broken(gi, corrupt)):
            bad = seg(xyz, pmask)
        ok, msg = labels_agree(bad, seg_plain, pmask)
        print(f"negative control, {what}: {msg} -> "
              f"{'ACCEPTED' if ok else 'rejected'}")
        if ok:
            raise AssertionError(f"the PointNet++(s) check accepts a forward "
                                 f"with {what}")

    # 7. the other five models, through the kernel and plain
    others = [
        ("PointNet", pointnet, {}, pointnet_plain),
        ("PointNet++(c)", model("pointnetpp_cls_init", 2, n_classes=40), {},
         None),
        ("PointNet++(ps)", model("pointnetpp_seg_init", 3, n_classes=50),
         {}, None),
        ("DGCNN", model("dgcnn_init", 4, n_classes=16), {"k": 20}, None),
        ("F-PointNet++", model("fpointnetpp_init", 5), {}, None),
    ]
    cloud_rows = torch.ones(OTHER_BATCH[2], dtype=torch.bool, device=dev)
    for label, net, kw, plain in others:
        if plain is None:
            with mlp_groups_through(plain_groups()):
                plain = net(oxyz, omask, **kw)
        before = FK.LAUNCHES["fused_mlp"]
        out = net(oxyz, omask, **kw)
        torch.cuda.synchronize()
        n_launch = FK.LAUNCHES["fused_mlp"] - before
        print(f"{label}: {n_launch} fused_mlp launches")
        if n_launch != planned_launches(net.tree()):
            raise AssertionError(f"{label}: {n_launch} launches, planned "
                                 f"{planned_launches(net.tree())}")
        if label == "F-PointNet++":
            for key in ("center", "box"):
                ok, err, scale = rel_close(out[key], plain[key])
                print(f"{label} {key}: max abs err {err:.2e}, max|plain| "
                      f"{scale:.3g}")
                if not ok:
                    raise AssertionError(f"{label} {key} differs from plain")
            out, plain = out["seg"], plain["seg"]
        check_labels(label, out, plain,
                     omask if out.dim() == 3 else cloud_rows)

    if with_profile:
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.core import pointops
        from repro_torch.kernels.fused_mlp import ops as fops
        labelled = [(pointops, "farthest_point_sampling", "fps"),
                    (pointops, "ball_query", "ball_query"),
                    (pointops, "knn", "knn"),
                    (pointops, "gather_points", "gather_points"),
                    (fops, "fused_mlp", "fused_mlp_group")]
        saved = [getattr(mod, fn) for mod, fn, _ in labelled]

        def labelled_fn(fn, label):
            def run(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return run
        for (mod, fn, label), orig in zip(labelled, saved):
            setattr(mod, fn, labelled_fn(orig, label))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                seg(xyz, pmask)
                torch.cuda.synchronize()
        finally:
            for (mod, fn, _), orig in zip(labelled, saved):
                setattr(mod, fn, orig)
        rows = prof.key_averages()
        print(rows.table(sort_by="cuda_time_total", row_limit=25))

        def busy_us(evt):
            return evt.time_range.end - evt.time_range.start
        names = {lab for _, _, lab in labelled}
        split = []
        for evt in rows:
            if evt.key in names and evt.cpu_time_total > 0:
                split.append(f"{evt.key}: {evt.count} calls, host "
                             f"{evt.cpu_time_total / 1e3:.2f} ms, device "
                             f"{evt.device_time_total / 1e3:.3f} ms")
        # device events without the GPU-side spans of the labels above,
        # which cover idle time between their kernels
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and e.name not in names
                         and not getattr(e, "is_user_annotation", False)]
        kernel_events = [e for e in device_events
                         if "fused_mlp_kernel" in e.name]
        print("PointNet++(s) forward split under the profiler (device = "
              "kernels the profiler ties to the calls; ball_query includes "
              "its knn; the ctypes launches are not tied to "
              "fused_mlp_group): " + "; ".join(split))
        print(f"PointNet++(s) profiled forward: device time of all device "
              f"events (kernels, copies, fills) "
              f"{sum(busy_us(e) for e in device_events) / 1e3:.3f} ms over "
              f"{len(device_events)}; fused_mlp_kernel "
              f"{sum(busy_us(e) for e in kernel_events) / 1e3:.3f} ms over "
              f"{len(kernel_events)} launches")
    return point_launches, mlp


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import PointAccSession
    from repro_torch.data.synthetic import city_scene
    from repro_torch.kernels import build
    from repro_torch.kernels.spconv import ops, ref
    from repro_torch.kernels.spconv import spconv as K
    from repro_torch.models import minkunet as MU
    from repro_torch.serve.buckets import pad_scene
    from repro_torch.serve.engine import PointCloudEngine

    # 1. device
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}  count={torch.cuda.device_count()}  torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    mem_rate, flop_rate = PEAKS["pcie" if "PCIe" in name else "sxm"]

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} librar(y/ies) from csrc/ in "
          f"{time.perf_counter() - t0:.2f} s")
    for log in build.build_log.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    scenes = {key: city_scene(*key) for key in (SCENE_A, SCENE_B)}
    module = MU.minkunet_init(torch.Generator().manual_seed(0))
    tree = module.tree()

    # 3. kernels, on the inputs of every conv of one forward
    sites = []

    class Recording(PointAccSession):
        def _apply_conv(self, x, maps, out_pc, weights, epilogue, new_stride):
            epi = epilogue._replace(
                mask=epilogue.mask.float().contiguous(),
                residual=None if epilogue.residual is None
                else epilogue.residual.contiguous())
            sites.append({"features": x.feats.contiguous(),
                          "inv": ops.invert_maps(maps, out_pc.capacity),
                          "weights": weights.contiguous(), "epi": epi})
            return super()._apply_conv(x, maps, out_pc, weights, epilogue,
                                       new_stride)

    probe = PointCloudEngine(module, N_STAGES, flow="fod")
    coords, mask, feats = scenes[SCENE_A]
    levels, _ = probe.levels_for(coords, mask)
    session = Recording(flow="fod")
    bucket = probe.ladder.bucket_for(coords.shape[0])
    c, m, f = pad_scene(coords, mask, feats, bucket)
    dev = probe.device
    x = session.tensor(torch.from_numpy(c).to(dev), torch.from_numpy(m).to(dev),
                       torch.from_numpy(f).to(dev),
                       context=MU._context_from_levels(levels))
    fod_logits = MU.minkunet_forward(session, probe.module.tree(), x)
    fod_logits = fod_logits[:coords.shape[0]]
    names = site_names(tree)
    if not len(sites) == len(names) == 41:
        raise AssertionError(f"{len(sites)} conv sites recorded, "
                             f"{len(names)} named; expected 41")

    print(f"kernel phase: {len(sites)} conv sites of one forward, tol "
          f"atol=rtol={TOL:g}; times in ms (CUDA events, mean of {REPS})")
    print(f"{'site':14s} {'K':>2s} {'Cin':>4s} {'Cout':>4s} {'M':>6s} "
          f"{'nnz':>7s} {'err_fused':>9s} {'err_base':>9s} {'fused':>7s} "
          f"{'base':>7s} {'plain_f':>7s} {'plain_b':>7s} {'gemm':>7s} "
          f"{'bound':>7s} {'row_use':>7s}")
    totals = {"fused": 0.0, "base": 0.0, "plain_f": 0.0, "plain_b": 0.0,
              "gemm": 0.0, "bound_f": 0.0, "bound_b": 0.0, "bound_ops": 0.0,
              "bytes_f": 0.0, "bytes_b": 0.0, "err_f": 0.0, "err_b": 0.0,
              "flops": 0.0, "dense_flops": 0.0}
    for nm, s in zip(names, sites):
        fe, inv, w, epi = s["features"], s["inv"], s["weights"], s["epi"]
        k, mrows = inv.shape
        cin, cout = w.shape[1], w.shape[2]
        out_f = K.spconv_fod_fused_cuda(fe, inv, w, epi)
        ref_f = ref.spconv_fod_fused_ref(fe, inv, w, epi)
        out_b = K.spconv_fod_cuda(fe, inv, w)
        ref_b = ref.spconv_fod_ref(fe, inv, w)
        torch.cuda.synchronize()
        for out, want, what in ((out_f, ref_f, "fused"), (out_b, ref_b,
                                                          "baseline")):
            if not torch.allclose(out, want, atol=TOL, rtol=TOL):
                raise AssertionError(
                    f"{what} kernel disagrees with its plain version at {nm}"
                    f": max abs err {float((out - want).abs().max())}")
        err_f = float((out_f - ref_f).abs().max())
        err_b = float((out_b - ref_b).abs().max())
        valid = inv >= 0
        nnz = int(valid.sum())
        rows_read = int(torch.unique(inv[valid]).numel())
        flops = 2.0 * nnz * cin * cout
        # rows the kernel computes: every row of each (tile, offset) slice
        # that holds at least one input
        tiles = -(-mrows // K.ROWS_PER_CTA)
        padded = torch.full((k, tiles * K.ROWS_PER_CTA), -1,
                            dtype=inv.dtype, device=inv.device)
        padded[:, :mrows] = inv
        live = int((padded.view(k, tiles, -1) >= 0).any(-1).sum())
        row_use = nnz / max(1, live * K.ROWS_PER_CTA)
        nbytes = 4 * (rows_read * cin + k * mrows + k * cin * cout
                      + mrows * cout)
        fused_bytes = nbytes + 4 * (2 * cout + mrows) \
            + (4 * mrows * cout if epi.residual is not None else 0)
        b_ops = flops / flop_rate * 1e3
        b_bytes_f, b_bytes_b = (fused_bytes / mem_rate * 1e3,
                                nbytes / mem_rate * 1e3)
        gathered = fe[inv.clamp(min=0).long()] * valid[..., None]
        t = {"fused": cuda_ms(lambda: K.spconv_fod_fused_cuda(fe, inv, w, epi),
                              REPS),
             "base": cuda_ms(lambda: K.spconv_fod_cuda(fe, inv, w), REPS),
             "plain_f": cuda_ms(
                 lambda: ref.spconv_fod_fused_ref(fe, inv, w, epi), REPS),
             "plain_b": cuda_ms(lambda: ref.spconv_fod_ref(fe, inv, w), REPS),
             "gemm": cuda_ms(
                 lambda: torch.einsum("kmc,kcd->md", gathered, w), REPS)}
        del gathered
        bound = max(b_ops, b_bytes_f)
        for key in t:
            totals[key] += t[key]
        totals["bound_f"] += bound
        totals["bound_b"] += max(b_ops, b_bytes_b)
        totals["bound_ops"] += b_ops
        totals["bytes_f"] += b_bytes_f
        totals["bytes_b"] += b_bytes_b
        totals["flops"] += flops
        totals["dense_flops"] += 2.0 * live * K.ROWS_PER_CTA * cin * cout
        totals["err_f"] = max(totals["err_f"], err_f)
        totals["err_b"] = max(totals["err_b"], err_b)
        print(f"{nm:14s} {k:2d} {cin:4d} {cout:4d} {mrows:6d} {nnz:7d} "
              f"{err_f:9.2e} {err_b:9.2e} {t['fused']:7.3f} {t['base']:7.3f} "
              f"{t['plain_f']:7.3f} {t['plain_b']:7.3f} {t['gemm']:7.3f} "
              f"{bound:7.4f} {row_use:7.3f}  {NAMED.get(nm, '')}")
    print(f"{'total':14s} real GFLOP {totals['flops'] / 1e9:.2f}  computed "
          f"GFLOP {totals['dense_flops'] / 1e9:.2f}  fused "
          f"{totals['fused']:.3f} ms  base {totals['base']:.3f} ms  plain_f "
          f"{totals['plain_f']:.3f} ms  plain_b {totals['plain_b']:.3f} ms  "
          f"gemm-only {totals['gemm']:.3f} ms  bound fused "
          f"{totals['bound_f']:.4f} ms, base {totals['bound_b']:.4f} ms "
          f"(ops {totals['bound_ops']:.4f}, bytes fused "
          f"{totals['bytes_f']:.4f}, base {totals['bytes_b']:.4f})")

    # 4. main path
    engine = PointCloudEngine(module, N_STAGES, flow="cuda_fused")
    baseline = PointCloudEngine(module, N_STAGES, flow="cuda")
    order = [SCENE_A, SCENE_B, SCENE_A, SCENE_B, SCENE_A]
    K.reset_launch_counts()
    results = []
    for i, key in enumerate(order):
        coords, mask, feats = scenes[key]
        before = K.LAUNCHES["spconv_fod_fused"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, hit = engine.segment(coords, mask, feats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fused_launches = K.LAUNCHES["spconv_fod_fused"] - before
        results.append((key, preds, hit, ms))
        print(f"request {i}: scene {key} n={coords.shape[0]} bucket "
              f"{engine.ladder.bucket_for(coords.shape[0])} hit={hit} "
              f"latency {ms:.2f} ms fused launches {fused_launches}")
        if fused_launches != 41:
            raise AssertionError(f"request {i}: {fused_launches} fused "
                                 "launches, expected 41")
    coords, mask, feats = scenes[SCENE_A]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base_preds, _ = baseline.segment(coords, mask, feats)
    torch.cuda.synchronize()
    base_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    print(f"flow=cuda request: scene {SCENE_A} latency {base_ms:.2f} ms "
          f"(mapping miss in its own cache)")
    print(f"main-path launches: {launches}")
    if launches["spconv_fod_fused"] != 41 * len(order):
        raise AssertionError(f"fused launches {launches}")
    if launches["spconv_fod"] != 41:
        raise AssertionError(f"baseline launches {launches}")
    hits = [hit for _, _, hit, _ in results]
    if hits != [False, False, True, True, True]:
        raise AssertionError(f"mapping-cache hits {hits}")
    print("mapping cache:", engine.cache_stats())
    hit_ms = [ms for _, _, hit, ms in results if hit]
    print(f"segment latency at the 65536 bucket: misses "
          f"{[round(ms, 2) for _, _, h, ms in results if not h]} ms, hits "
          f"{[round(ms, 2) for ms in hit_ms]} ms, median hit "
          f"{statistics.median(hit_ms):.2f} ms")

    # labels against the plain "fod" logits, on valid rows
    valid = torch.from_numpy(mask).to(fod_logits.device)
    top2 = fod_logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    want = fod_logits.argmax(-1)
    n_classes = fod_logits.shape[1]
    for label, preds in (("cuda_fused", results[0][1]),
                         ("cuda_fused repeat", results[4][1]),
                         ("cuda", base_preds)):
        if preds.shape != want.shape or int(preds.min()) < 0 \
                or int(preds.max()) >= n_classes:
            raise AssertionError(f"{label}: bad predictions {preds.shape}")
        diff = (preds != want) & valid
        close = diff & (gap < TOL)
        print(f"labels {label} vs fod: {int(diff.sum())} of "
              f"{int(valid.sum())} valid rows differ, {int(close.sum())} of "
              f"them within a top-2 gap < {TOL:g}")
        if int((diff & ~close).sum()):
            raise AssertionError(f"{label}: labels differ from fod beyond "
                                 "the tolerance")
    if not torch.equal(results[0][1], results[4][1]):
        raise AssertionError("repeat request gave different predictions")
    if not bool(torch.isfinite(fod_logits).all()):
        raise AssertionError("non-finite logits")

    point_launches, mlp = point_phases(dev, mem_rate, flop_rate,
                                       "--profile" in argv)

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile
        coords, mask, feats = scenes[SCENE_A]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.segment(coords, mask, feats)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=15))

    # 8. result lines
    src = "src/repro_torch/kernels/spconv/csrc/spconv.cu"
    kernels = [
        {"name": "spconv_fod_fused", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/spconv/spconv.py:190",
         "launches": launches["spconv_fod_fused"],
         "max_abs_err": totals["err_f"], "ms": totals["fused"],
         "kernel_ms": totals["fused"], "plain_ms": totals["plain_f"],
         "bound_ms": totals["bound_f"],
         "bound_by": "operations" if totals["bound_ops"]
         >= totals["bytes_f"] else "bytes",
         "library_ms": None, "gemm_only_ms": totals["gemm"],
         "per": "one forward: sum over its 41 conv sites"},
        {"name": "spconv_fod", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/spconv/spconv.py:82",
         "launches": launches["spconv_fod"],
         "max_abs_err": totals["err_b"], "ms": totals["base"],
         "kernel_ms": totals["base"], "plain_ms": totals["plain_b"],
         "bound_ms": totals["bound_b"],
         "bound_by": "operations" if totals["bound_ops"]
         >= totals["bytes_b"] else "bytes",
         "library_ms": None, "gemm_only_ms": totals["gemm"],
         "per": "one forward: sum over its 41 conv sites"},
        {"name": "fused_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu",
         "replaces": "src/repro/kernels/fused_mlp/fused_mlp.py:42",
         "launches": point_launches["fused_mlp"],
         "max_abs_err": mlp["err"], "ms": mlp["ms"],
         "kernel_ms": mlp["ms"], "plain_ms": mlp["plain"],
         "bound_ms": mlp["bound"],
         "bound_by": "operations" if mlp["ops"] >= mlp["bytes"]
         else "bytes",
         "library_ms": mlp["cublas"],
         "library": "cuBLAS layer by layer (torch.addmm + relu_)",
         "timing": "device ms a call: 20 calls in one CUDA graph",
         "per": "one PointNet++(s) forward (16 x 4096): sum over its 6 "
                "groups"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
