"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` source under this package compiles, at first use, into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

All sources build at once, one `nvcc` each, into
`build/repro_torch_kernels/<hash of the sources>/` at the repository root,
and load with `ctypes`.  A missing `nvcc` raises: there is no fallback.

The LM kernels are also dispatcher ops (`define_op`): `repro_torch::
flash_attention`, `flash_decode`, `grouped_matmul` and `grouped_matmul_dw`,
each with its launch as the CUDA implementation, a fake implementation
(the output's shape and dtype, for `FakeTensorMode`) and a FLOP formula
(`FlopCounterMode` and the dry run's counter read it).  Their byte count
is each operand read once plus the output written once: the dry run's
rule for every op (`launch/dryrun.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
BUILD_ROOT = PKG_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LIB = torch.library.Library("repro_torch", "DEF")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # source name -> nvcc's output (ptxas -v),
                                 # kept beside each library as lib<name>.log


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(PKG_DIR.glob("**/csrc/*.cu"))}


def tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): PATH, then
    $CUDA_HOME/bin, then /usr/local/cuda/bin; raises if none has it."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        f"{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built or inspected")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, all in parallel;
    returns {name: library path}.  Raises with nvcc's output on failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {name: src for name, src in sources().items()
            if not libs[name].exists()}
    for name in libs.keys() - todo.keys():
        log = out_dir / f"lib{name}.log"
        build_log.setdefault(name, log.read_text() if log.exists() else "")
    if not todo:
        return libs
    nvcc = tool("nvcc")
    procs = {}
    for name, src in todo.items():
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        (out_dir / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built on first use)."""
    with _lock:
        if name not in _libs:
            libs = build_all()
            if name not in libs:
                raise KeyError(f"no CUDA source csrc/{name}.cu in {PKG_DIR}")
            _libs[name] = ctypes.CDLL(str(libs[name]))
        return _libs[name]


def device_operand(t: torch.Tensor, what: str, device) -> int:
    """The data pointer of `t` for a launch on `device`; raises unless `t`
    lies there and is contiguous."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return t.data_ptr()


def define_op(schema: str, cuda, fake, flops):
    """Define `repro_torch::<schema>` with `cuda` as its CUDA kernel (a
    Python launch), `fake` as its fake implementation and `flops(*shapes,
    out_shape)` as its FLOP formula; returns the op's default overload.
    The dispatcher is entered only for CUDA (and fake) tensors: a wrapper
    takes the plain version of a CPU tensor before it calls the op."""
    from repro_torch import compat
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    compat.register_flop_formula(packet)(flops)
    return packet.default
