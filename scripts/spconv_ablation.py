#!/usr/bin/env python3
"""Time variants of the tensor-core sparse conv (`csrc/spconv_tc.cu`) at the
41 conv sites of a full-width MinkUNet forward, on one NVIDIA GPU.

    python3 scripts/spconv_ablation.py

Each variant is the kernel source with one compile-time choice flipped,
or the main path's plan (`spconv.plan_for`) with one choice changed; each
distinct source is built with the port's nvcc flags into
`build/spconv_ablation/<variant>/` and launched through ctypes:

  main          the source and the plan as they are;
  waves_4       the main source with twice the clusters (4 waves of CTAs:
                the plan for twice the SMs);
  n_split_4     the main source with clusters of 4 CTAs at every site;
  n_split_8     the main source with clusters of 8 CTAs at every site;
  kk_rolled     the stage's four k8 steps in a loop, not unrolled (a
                quarter of the main loop's code);
  one_cta_sm    launch bounds of one CTA an SM (up to 255 registers, no
                spills), the grid as planned.

Every call is checked against the plain version (atol = rtol = 1e-4), then
timed as device time a call (chip_smoke.graph_ms: a CUDA graph of 10
calls), fused and unfused.  At each site the calls run in the order main,
every variant, every variant again, main, and each variant's time is the
mean of its two turns, so that all see the card in the same state.  The
sites and the per-level sums come from chip_smoke.py (`record_sites`,
`level_of`).  Prints per-level and total ms of each variant, the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

VARIANTS = {  # name: (source edits, plan changes)
    "main": ({}, {}),
    "waves_4": ({}, {"sm_scale": 2}),
    "n_split_4": ({}, {"n_split": 4}),
    "n_split_8": ({}, {"n_split": 8}),
    "kk_rolled": ({"#pragma unroll\n      for (int kk = 0; kk < kChunk; kk += 8)":
                   "#pragma unroll 1\n      for (int kk = 0; kk < kChunk; kk += 8)"}, {}),
    "one_cta_sm": ({"__launch_bounds__(kThreads, 2)": "__launch_bounds__(kThreads, 1)"},
                   {}),
}
REPS = 10


def build_variant(name: str, edits: dict) -> ctypes.CDLL:
    from repro_torch.kernels import build
    src = (ROOT / "src/repro_torch/kernels/spconv/csrc/spconv_tc.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            raise AssertionError(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out = ROOT / "build" / "spconv_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "spconv_tc.cu").write_text(src)
    lib = out / "libspconv_tc.so"
    subprocess.run([build.tool("nvcc"), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "spconv_tc.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def caller(lib, name, site, fused):
    """A zero-argument launch of `lib` on one site, and its output."""
    import torch
    from repro_torch.kernels.spconv import spconv as K
    fe, inv, w, epi = site["features"], site["inv"], site["weights"], site["epi"]
    (n, cin), (k, m), cout = fe.shape, inv.shape, w.shape[2]
    changes = VARIANTS[name][1]
    n_sm = torch.cuda.get_device_properties(fe.device).multi_processor_count
    plan = K.plan_for(fe, inv, w, fused=fused, n_split=changes.get("n_split"),
                      n_sm=changes.get("sm_scale", 1) * n_sm)
    out = torch.empty((m, cout), device=fe.device)
    fn = lib.spconv_fod_fused_tc if fused else lib.spconv_fod_tc
    fn.argtypes = K.ARGTYPES["spconv_fod_fused_tc" if fused else "spconv_fod_tc"]
    fn.restype = ctypes.c_int
    args = [fe.data_ptr(), inv.data_ptr(), w.data_ptr()]
    if fused:
        args += [None if t is None else t.data_ptr() for t in
                 (epi.bias, epi.ln_scale, epi.ln_bias, epi.residual, epi.mask)]
    args += [out.data_ptr(), n, cin, k, m, cout]
    if fused:
        args.append(int(bool(epi.relu)))
    args += [plan.n_split, plan.clusters, plan.cn, None]   # no device counts

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("spconv_ablation: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import city_scene
    from repro_torch.kernels.spconv import ref
    from repro_torch.models import minkunet as MU
    print(CS.smi_line())
    built = {}                 # one build a distinct source
    libs = {}
    for name, (edits, _) in VARIANTS.items():
        key = tuple(sorted(edits.items()))
        if key not in built:
            built[key] = build_variant(name, edits)
        libs[name] = built[key]
    module = MU.minkunet_init(torch.Generator().manual_seed(0))
    sites, _ = CS.record_sites(module, city_scene(*CS.SCENE_A))
    names = CS.site_names(module.tree())
    totals: dict = {}
    order = ["main"] + [v for v in VARIANTS if v != "main"] * 2 + ["main"]
    for nm, site in zip(names, sites):
        fe, inv, w, epi = site["features"], site["inv"], site["weights"], site["epi"]
        for fused in (True, False):
            want = (ref.spconv_fod_fused_ref(fe, inv, w, epi) if fused
                    else ref.spconv_fod_ref(fe, inv, w))
            for name in order:
                call, out = caller(libs[name], name, site, fused)
                call()
                torch.cuda.synchronize()
                if not torch.allclose(out, want, atol=CS.TOL, rtol=CS.TOL):
                    raise AssertionError(f"{name} disagrees at {nm}")
                ms = CS.graph_ms(call, REPS) / order.count(name)
                for key in ((name, fused), (name, fused, CS.level_of(nm))):
                    totals[key] = totals.get(key, 0.0) + ms
    for name in VARIANTS:
        for fused in (True, False):
            levels = "  ".join(f"level {lv} {totals[(name, fused, lv)]:.3f}"
                               for lv in range(CS.N_STAGES + 1))
            print(f"{name:14s} {'fused' if fused else 'base':5s} total "
                  f"{totals[(name, fused)]:.3f} ms  {levels}")
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
