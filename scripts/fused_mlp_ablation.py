#!/usr/bin/env python3
"""Time variants of the tensor-core fused MLP (`csrc/fused_mlp_tc.cu`) at
the six groups of a PointNet++(s) forward (16 x 4096 points), on one
NVIDIA GPU.

    python3 scripts/fused_mlp_ablation.py

Each variant is the kernel source with one compile-time choice changed,
or the planned launch (`fused_mlp.plan_mlp`) with one choice changed; each
distinct source is built with the port's nvcc flags into
`build/fused_mlp_ablation/<variant>/` and launched through ctypes on
seeded operands of the groups' shapes (chip_smoke.PN_SEG_GROUPS, weights
He-scaled as the smoke's):

  main          the source and the plan as they are;
  w_smem        W split once into (hi, hi, lo, lo) in shared memory at
                load (a B fragment one 16-byte load, no conversion) in
                place of the split in registers for each fragment, where
                twice the W fits (the other choice for W);
  rows_32       tiles of 32 rows where the plan takes 64;
  one_cta_sm    launch bounds of one CTA an SM (up to 255 registers);
  one_product   hi*hi alone (timing only: misses float32 accuracy);
  no_store      the last layer computes but writes nothing (timing only);
  no_mma        each HMMA replaced by one float add on its accumulator
                (timing only: what the kernel costs without the tensor
                cores);
  no_layers     the layers skipped: the prologue, the x stream and the
                barriers alone (timing only);
  one_tile      each CTA takes its first row tile only: the prologue and
                one tile (timing only);
  no_w          W and b not loaded (timing only: the prologue's cost).

Every exact variant is checked against the plain version (max|err| <=
1e-5 * max|plain|), then each is timed as device time a call
(chip_smoke.graph_ms: a CUDA graph of 20 calls).  At each group the calls
run in the order main, every variant, every variant again, main, and a
variant's time is the mean of its two turns.  Prints per-group and total
ms of each variant, and the card's name and power limit.
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

SRC = ROOT / "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp_tc.cu"
VARIANTS = {  # name: (source edits, plan changes, exact)
    "main": ({}, {}, True),
    "w_smem": ({
        """      split(q.x, hi[0], lo[0]);
      split(q.y, hi[1], lo[1]);""": """      const float4 p = reinterpret_cast<const float4*>(w)[f];
      hi[0] = __float_as_uint(p.x);
      hi[1] = __float_as_uint(p.y);
      lo[0] = __float_as_uint(p.z);
      lo[1] = __float_as_uint(p.w);""",
        "  constexpr int Q = 2;": "  constexpr int Q = BF16 ? 2 : 4;",
        """  if (int(blockIdx.x) < ch.tiles) load_x<R, BF16>(ch, xbuf(0), blockIdx.x * R);
  cp_async_commit();
""": """  if (int(blockIdx.x) < ch.tiles) load_x<R, BF16>(ch, xbuf(0), blockIdx.x * R);
  cp_async_commit();
  if constexpr (!BF16) {
    cp_async_wait<0>();
    __syncthreads();
    for (int l = 0; l < ch.n_layers; ++l) {
      const int pairs = round8(ch.widths[l]) / 8 * (round8(ch.widths[l + 1]) / 8) * 32;
      float4* wl = reinterpret_cast<float4*>(sm + ch.off_w[l]);
      for (int f = tid; f < pairs; f += kThreads) {
        const float4 q = wl[f];
        uint32_t h0, l0, h1, l1;
        split(q.x, h0, l0);
        split(q.y, h1, l1);
        wl[f] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                            __uint_as_float(l0), __uint_as_float(l1));
      }
    }
  }
""",
        "      words += round8(ch.widths[l]) * n8;":
        "      words += round8(ch.widths[l]) * n8 * (bf16 ? 1 : 2);"},
        {"w_once": True}, True),
    "rows_32": ({}, {"rows": 32}, True),
    "one_cta_sm": ({"__launch_bounds__(kThreads, 2)":
                    "__launch_bounds__(kThreads, 1)"}, {}, True),
    "one_product": ({"resident_layer<R, BF16 ? 1 : 3>":
                     "resident_layer<R, 1>",
                     "resident_layer<R, BF16 ? 2 : 3>":
                     "resident_layer<R, 1>"}, {}, False),
    "no_store": ({"store2<BF16>(out, size_t(row0 + r) * n + c, v0, v1, even, "
                  "c + 1 < n);":
                  "if (v0 == 1234.5f) store2<BF16>(out, size_t(row0 + r) * n "
                  "+ c, v0, v1, even, c + 1 < n);"}, {}, False),
    "no_mma": ({'''  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''':
                '''  d[0] += __uint_as_float(a[0] ^ b0);
  d[1] += __uint_as_float(a[1] ^ b1);
  d[2] += __uint_as_float(a[2] ^ b0);
  d[3] += __uint_as_float(a[3] ^ b1);'''}, {}, False),
    "no_layers": ({"    for (int l = 0; l < ch.n_layers; ++l) {\n      if (l > 0) __syncthreads();":
                   "    for (int l = 0; l < 0; ++l) {\n      if (l > 0) __syncthreads();"},
                  {}, False),
    "one_tile": ({"for (int tile = blockIdx.x; tile < ch.tiles; tile += gridDim.x, ++it)":
                  "for (int tile = blockIdx.x; tile < ch.tiles; tile += ch.tiles, ++it)"},
                 {}, False),
    "no_w": ({"  for (int l = 0; l < ch.n_layers; ++l) {\n    const int k = ch.widths[l], n = ch.widths[l + 1];\n    const int nt = round8(n) / 8, pairs":
              "  for (int l = 0; l < 0; ++l) {\n    const int k = ch.widths[l], n = ch.widths[l + 1];\n    const int nt = round8(n) / 8, pairs"},
             {}, False),
}
REPS = 20


def build_variant(name: str, edits: dict) -> ctypes.CDLL:
    from repro_torch.kernels import build
    src = SRC.read_text()
    for old, new in edits.items():
        if old not in src:
            raise AssertionError(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out = ROOT / "build" / "fused_mlp_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_mlp_tc.cu").write_text(src)
    lib = out / "libfused_mlp_tc.so"
    subprocess.run([build.tool("nvcc"), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "fused_mlp_tc.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def caller(lib, name, x, ws, bs, final_act):
    """A zero-argument launch of `lib`'s resident route on one group, and
    its output; None where the variant's plan does not fit."""
    import torch
    from repro_torch.kernels.fused_mlp import fused_mlp as F
    changes = VARIANTS[name][1]
    widths = (x.shape[1],) + tuple(w.shape[1] for w in ws)
    n, n_sm = x.shape[0], F._sm_count(x.device.index)
    plan = F.plan_for(x, ws, bs)
    rows = changes.get("rows", plan.rows)
    if plan.variant != "tc" or rows > plan.rows and "rows" in changes:
        return None, None
    smem = F.tc_smem(widths, rows, False, False)
    if changes.get("w_once"):             # W twice: (hi, lo) of each value
        smem += 4 * sum(F._r8(a) * F._r8(b) for a, b in zip(widths, widths[1:]))
    if smem > F.SMEM_BYTES:
        return None, None
    tiles = -(-n // rows)
    ctas = min(tiles, F.ctas_per_sm(smem) * n_sm)
    out = torch.empty((n, widths[-1]), device=x.device)
    fn = lib.fused_mlp_tc
    fn.argtypes = F.ARGTYPES["fused_mlp_tc"]
    fn.restype = ctypes.c_int
    L = len(ws)
    args = [x.data_ptr(), out.data_ptr(),
            (ctypes.c_void_p * L)(*[w.data_ptr() for w in ws]),
            (ctypes.c_void_p * L)(*[b.data_ptr() for b in bs]),
            (ctypes.c_int * (L + 1))(*widths), L, n, 0, rows, ctas, 1, 0,
            int(final_act), smem]

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call, out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_mlp_ablation: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    print(CS.smi_line())
    built, libs = {}, {}
    for name, (edits, _, _) in VARIANTS.items():
        key = tuple(sorted(edits.items()))
        if key not in built:
            built[key] = build_variant(name, edits)
        libs[name] = built[key]
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    totals = dict.fromkeys(VARIANTS, 0.0)
    order = ["main"] + [v for v in VARIANTS if v != "main"] * 2 + ["main"]
    print(f"{'group':8s} " + " ".join(f"{v:>11s}" for v in VARIANTS))
    for gname, widths, rows in CS.PN_SEG_GROUPS:
        x = dev(rng.normal(size=(rows, widths[0])))
        ws = [dev(rng.uniform(-1, 1, size=(a, b)) * np.sqrt(6.0 / a))
              for a, b in zip(widths[:-1], widths[1:])]
        bs = [dev(rng.uniform(-0.1, 0.1, size=b)) for b in widths[1:]]
        final_act = gname != "head"
        want = fused_mlp_ref(x, ws, bs, final_act)
        ms = dict.fromkeys(VARIANTS, 0.0)
        for name in order:
            call, out = caller(libs[name], name, x, ws, bs, final_act)
            if call is None:
                ms[name] = float("nan")
                continue
            call()
            torch.cuda.synchronize()
            ok, err, scale = CS.rel_close(out, want)
            if VARIANTS[name][2] and not ok:
                raise AssertionError(f"{name} disagrees at {gname}: {err} "
                                     f"against max|plain| {scale}")
            ms[name] += CS.graph_ms(call, REPS) / order.count(name)
        for name in VARIANTS:
            totals[name] += ms[name] if ms[name] == ms[name] else ms["main"]
        print(f"{gname:8s} " + " ".join(f"{ms[v]:11.4f}" for v in VARIANTS))
    print(f"{'total':8s} " + " ".join(f"{totals[v]:11.4f}" for v in VARIANTS)
          + "  (a variant that does not fit a group counts main's time)")
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
