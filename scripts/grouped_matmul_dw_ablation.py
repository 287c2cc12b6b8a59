#!/usr/bin/env python3
"""Time variants of the tensor-core weight gradient of the grouped matmul
(`csrc/grouped_matmul_dw_wgmma.cu`) at the LM train step's shapes, on one
NVIDIA GPU.

    python3 scripts/grouped_matmul_dw_ablation.py

granite-moe-1b-a400m's train step (4 x 512 tokens, 32 experts, top 8,
capacity 896, 128-row tiles) gives R = 28,672 rows a call, x (R, Cin) and
dY (R, Cout) in bf16 with (Cin, Cout) = (1024, 512) for w_in / w_gate and
(512, 1024) for w_out; operands come from a seed.  Each variant is the
kernel source with one compile-time choice changed, built with the port's
nvcc flags into `build/dw_ablation/<variant>/` and launched through ctypes:

  main             the source as it is (128 x 256 tiles of dW);
  tile_128         128 x 128 tiles of dW (wgmma m64n128k16);
  stages_3         a ring of 3 stages, not 4;
  no_store         the epilogue stages each tile in shared memory but
                   issues no TMA store (timing only, not checked).

Every other variant is first held against the plain version (8e-3 x
max|plain|).  Then each is timed as device time a call (20 calls in one
CUDA graph, operands rotated over copies that move twice the L2 between two
uses, as chip_smoke.py times them), in the order main, every variant,
every variant again, main; a variant's time is the mean of its two turns.
The float32-FMA kernel and one `torch.bmm` over the (E, Cin, capacity) x
(E, capacity, Cout) view are timed beside them, with the bound (bytes at
3.35 TB/s, bf16 operations at 989 TFLOP/s).  Prints the card's name and
power limit first and last.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

ROWS, EXPERTS, ROW_TILE = 28672, 32, 128
LAYOUTS = ((1024, 512), (512, 1024))
SOURCE = ROOT / "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul_dw_wgmma.cu"


def wgmma_asm(n: int) -> str:
    """The source's inline asm of one m64n{n}k16 wgmma, as it is written
    there for n = 256: n / 2 float32 accumulators a thread."""
    regs = n // 2
    lines = ['  asm volatile(', '      "{\\n\\t.reg .pred p;\\n\\t"',
             f'      "setp.ne.b32 p, %{regs + 2}, 0;\\n\\t"',
             f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{"']
    for i in range(0, regs, 8):
        sep = "" if i + 8 == regs else ", "
        lines.append(f'      "{", ".join(f"%{j}" for j in range(i, i + 8))}{sep}"')
    lines.append(f'      "}}, %{regs}, %{regs + 1}, p, 1, 1, 1, 1;\\n\\t}}"')
    for i in range(0, regs, 4):
        head = "      : " if i == 0 else "        "
        tail = "" if i + 4 == regs else ","
        lines.append(head + ", ".join(f'"+f"(d[{j}])' for j in range(i, i + 4))
                     + tail)
    lines.append('      : "l"(da), "l"(db), "r"(1));')
    return "\n".join(lines)


VARIANTS = {  # name: (source edits, checked)
    "main": ({}, True),
    "tile_128": ({"kBn = 256;": "kBn = 128;", wgmma_asm(256): wgmma_asm(128)},
                 True),
    "stages_3": ({"kStages = 4;": "kStages = 3;"}, True),
    "no_store": ({"q < kBn / 128; ++q)\n      tma_store_3d":
                  "q < 0; ++q)\n      tma_store_3d"}, False),
}


def build_variant(name: str, edits: dict) -> ctypes.CDLL:
    from repro_torch.kernels import build
    src = SOURCE.read_text()
    for old, new in edits.items():
        if src.count(old) != 1:
            raise AssertionError(f"variant {name}: {old!r} is not in the source "
                                 f"once")
        src = src.replace(old, new)
    out = ROOT / "build" / "dw_ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE.name).write_text(src)
    lib = out / "libdw.so"
    subprocess.run([build.tool("nvcc"), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / SOURCE.name)], check=True, capture_output=True,
                   text=True)
    fn = ctypes.CDLL(str(lib)).grouped_matmul_dw_wgmma
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn):
    """A call of the variant `fn` on operands (x, dy, eid)."""
    import torch

    def call(a):
        x, dy, eid = a
        out = torch.empty((EXPERTS, x.shape[1], dy.shape[1]), dtype=x.dtype,
                          device=x.device)
        err = fn(x.data_ptr(), dy.data_ptr(), eid.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], dy.shape[1], EXPERTS, ROW_TILE,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out
    return call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_dw_ref
    from repro_torch.launch.roofline import hardware
    print(CS.smi_line())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda kv: build_variant(kv[0], kv[1][0]), VARIANTS.items())))
    dev = torch.device("cuda")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    hw = hardware(torch.cuda.get_device_name(dev))
    mem_rate = hw.hbm_bw
    gen = torch.Generator(device=dev).manual_seed(0)
    cap = ROWS // EXPERTS
    eid = torch.arange(EXPERTS, dtype=torch.int32, device=dev) \
        .repeat_interleave(cap // ROW_TILE)
    for cin, cout in LAYOUTS:
        x = torch.randn((ROWS, cin), generator=gen, device=dev).bfloat16()
        dy = torch.randn((ROWS, cout), generator=gen, device=dev).bfloat16()
        calls = {name: (launcher(libs[name]), checked)
                 for name, (_, checked) in VARIANTS.items()}
        calls["fma"] = (lambda a: GM.grouped_matmul_dw_fma(
            a[0], a[1], a[2], EXPERTS, ROW_TILE), True)
        want = grouped_matmul_dw_ref(x, dy, eid, EXPERTS, ROW_TILE).float()
        scale = float(want.abs().max())
        for name, (fn, checked) in calls.items():
            if checked:
                err = float((fn((x, dy, eid)).float() - want).abs().max())
                if not err <= CS.LM_BF16_TOL * scale:
                    raise AssertionError(f"{name} at {cin} -> {cout}: error "
                                         f"{err:.3g} of max|plain| {scale:.3g}")
        calls["torch.bmm"] = (lambda a: torch.bmm(
            a[0].view(EXPERTS, cap, -1).transpose(1, 2),
            a[1].view(EXPERTS, cap, -1)), False)
        nbytes = 2 * (x.numel() + dy.numel() + EXPERTS * cin * cout) \
            + 4 * eid.numel()
        bound = max(nbytes / mem_rate, 2.0 * ROWS * cin * cout /
                    hw.peak_flops) * 1e3
        copies = CS.cold_copies((x, dy, eid), nbytes, l2)
        names = list(calls)
        order = names + names[::-1]
        times = dict.fromkeys(names, 0.0)
        for name in order:
            fn = calls[name][0]
            times[name] += CS.graph_ms(CS.rotating(
                [lambda a=a, fn=fn: fn(a) for a in copies]), CS.MLP_REPS) / 2
        print(f"dW at R {ROWS}, {cin} -> {cout}, {EXPERTS} experts (bf16, "
              f"cold; bound {bound:.4f} ms):")
        for name in names:
            print(f"  {name:24s} {times[name]:.4f} ms")
        del copies, x, dy
    print(CS.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
