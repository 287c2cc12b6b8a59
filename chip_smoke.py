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
  5. a {"kernels": [...]} line, the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.
"""

from __future__ import annotations

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

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile
        coords, mask, feats = scenes[SCENE_A]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.segment(coords, mask, feats)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=15))

    # 5. result lines
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
