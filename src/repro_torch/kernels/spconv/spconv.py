"""Wrappers of the fetch-on-demand sparse conv kernels.

  * `spconv_fod_cuda`       — the sum alone (`flow="cuda"`); replaces the
    reference's `spconv_fod_pallas`.
  * `spconv_fod_fused_cuda` — the sum with the epilogue folded into the
    flush (`flow="cuda_fused"`); replaces `spconv_fod_fused_pallas`.

Each launches the kernel that `variant` names: "tc" (`csrc/spconv_tc.cu`,
split-float TF32 on the tensor cores, a persistent grid of clusters of
`n_split` CTAs that spread a row tile's offsets over as many ranks as the
live tiles leave free) for float32 rows of whole 16-byte vectors (Cin and
Cout multiples of 4, features, weights, bias and residual 16-byte
aligned, Cout <= 256 fused), else "fma" (`csrc/spconv.cu`, float32 FMAs).  `plan_conv`
picks the launch from shapes, alignment and the SM count only, never from
the values in `inv`, so a captured call replays with new maps; how many
ranks share each tile is decided on the device (`round_groups` mirrors the
rule).  `n_split=` forces the cluster size (1..8) of the tensor-core
kernel.

A CPU tensor goes to the plain version (`ref.py`) and the launch counts do
not move.  A CUDA tensor launches a kernel on the current stream, or
raises; the output is allocated here with `torch.empty` and nothing
synchronises.  `LAUNCHES` counts kernel launches: each entry ("spconv_fod",
"spconv_fod_fused") every one, and one count per entry and variant; the
counts move under a lock, so launches from several threads (the serve
scheduler's producers and watchdog) all count.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from repro_torch.core.sparseconv import Epilogue
from repro_torch.kernels import build
from repro_torch.kernels.spconv.ref import spconv_fod_fused_ref, spconv_fod_ref

MAX_FUSED_COUT = 256   # one CTA tile owns the whole Cout row (layernorm)
ROWS_PER_CTA = 64      # output rows a CTA owns (kRows in both sources)
SKIP_ROWS = 16         # rows a tensor-core warp skips an offset by (m16)
MAX_SPLIT = 8          # CTAs a row tile: the portable cluster size
MAX_KVOL = 512         # kernel offsets the tensor-core kernel takes (kMaxKvol:
                       # its shared memory fits at every column tile)
CTAS_PER_SM = 2        # the kernel's launch bounds: 256 threads, <= 128 registers
WAVES = 2              # clusters for twice the CTAs the card holds: the hardware
                       # hands the second half to whichever SMs finish first
MAX_CLUSTER_TILES = 256  # row tiles a cluster may own (kMaxClusterTiles)
VARIANTS = ("tc", "fma")
# the tensor-core kernel's device counts (`spconv_fod_kernel(stats=)`)
STATS = ("busy_ctas",      # CTAs that ran at least one pipeline stage
         "stages",         # pipeline stages (offset x 32-channel chunk), all CTAs
         "max_stages",     # the most stages of one CTA
         "max_rounds")     # the most rounds of one cluster

LAUNCHES = {f"{entry}{suffix}": 0
            for entry in ("spconv_fod", "spconv_fod_fused")
            for suffix in ("", "_tc", "_fma")}

_P = ctypes.c_void_p
_I = ctypes.c_int
ARGTYPES = {  # the C entries' ctypes signatures
    "spconv_fod": [_P] * 4 + [_I] * 5 + [_P],
    "spconv_fod_fused": [_P] * 9 + [_I] * 6 + [_P],
    "spconv_fod_tc": [_P] * 4 + [_I] * 8 + [_P, _P],
    "spconv_fod_fused_tc": [_P] * 9 + [_I] * 9 + [_P, _P],
}


class Plan(NamedTuple):
    variant: str             # "tc" or "fma"
    rows: int                # output rows a CTA works on at a time
    cn: int                  # columns a CTA (32, 64, 128, 256)
    n_split: int             # CTAs a cluster: the most that share a row tile
    clusters: int            # persistent clusters (tc); row tiles (fma)
    grid: tuple[int, int]    # (clusters x n_split, Cout tiles)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def pick_cn(cout: int) -> int:
    return 32 if cout <= 32 else 64 if cout <= 64 else 128 if cout <= 128 \
        else 256


def variant(cin: int, cout: int, k: int, fused: bool,
            aligned: bool = True) -> str:
    """"tc" where the tensor-core kernel takes the shapes (rows of whole
    16-byte vectors, aligned operands, Cout <= 256 fused, at most MAX_KVOL
    offsets), else "fma"."""
    if not aligned or cin % 4 or cout % 4 or k > MAX_KVOL \
            or (fused and cout > MAX_FUSED_COUT):
        return "fma"
    return "tc"


def plan_splits(k: int, cn: int) -> int:
    """CTAs a cluster: the largest power of two <= min(cap, k), so that a
    cluster can spread one row tile's offsets over all its ranks; cap is
    MAX_SPLIT for 256-column tiles and half that for narrower ones, whose
    tiles hold a quarter of the work or less, so that smaller clusters
    (and more of them) balance better (scripts/spconv_ablation.py).  How
    many ranks share a tile is decided on the device, round by round, from
    the live tiles the cluster holds (`round_groups`)."""
    cap = MAX_SPLIT if cn > 128 else MAX_SPLIT // 2
    n = 1
    while 2 * n <= min(cap, k):
        n *= 2
    return n


def round_groups(left: int, n_split: int) -> list[tuple[int, int]]:
    """(first rank, ranks) of each group in a round of a cluster of
    `n_split` CTAs that has `left` live row tiles still to do: g =
    min(n_split, left) groups of contiguous ranks, one tile each (rank r in
    group r * g // n_split, as the kernel computes it)."""
    g = min(n_split, left)
    firsts = [-(-j * n_split // g) for j in range(g + 1)]
    return [(firsts[j], firsts[j + 1] - firsts[j]) for j in range(g)]


@functools.lru_cache(maxsize=1024)
def plan_conv(m: int, cin: int, cout: int, k: int, n_sm: int,
              n_split: int | None = None, fused: bool = True,
              aligned: bool = True) -> Plan:
    """The launch of a conv with `m` output rows, from shapes, operand
    alignment and the SM count only: the tensor-core kernel runs WAVES x
    CTAS_PER_SM x n_sm CTAs as clusters of `n_split` (at most one cluster a
    row tile, at most MAX_CLUSTER_TILES tiles a cluster)."""
    cn = pick_cn(cout)
    tiles = -(-m // ROWS_PER_CTA)
    col_tiles = 1 if fused else -(-cout // cn)
    kind = variant(cin, cout, k, fused, aligned)
    if kind == "fma":
        if n_split not in (None, 1):
            raise ValueError(f"the FMA kernel does not split (Cin {cin}, Cout "
                             f"{cout}, aligned {aligned}); n_split={n_split}")
        return Plan("fma", ROWS_PER_CTA, cn, 1, tiles, (tiles, col_tiles))
    if n_split is None:
        n_split = plan_splits(k, cn)
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split must be in 1..{MAX_SPLIT}, got {n_split}")
    clusters = min(tiles, max(WAVES * CTAS_PER_SM * n_sm // n_split,
                              -(-tiles // MAX_CLUSTER_TILES)))
    return Plan("tc", ROWS_PER_CTA, cn, n_split, clusters,
                (clusters * n_split, col_tiles))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(features: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor,
             *, fused: bool, n_split: int | None = None,
             n_sm: int | None = None, bias: torch.Tensor | None = None,
             residual: torch.Tensor | None = None) -> Plan:
    """`plan_conv` for these operands (their shapes and the 16-byte
    alignment of features, weights, `bias` and `residual`; `n_sm` defaults
    to the card's SM count)."""
    (k, m), (cin, cout) = inv.shape, weights.shape[1:]
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (features, weights, bias, residual) if t is not None)
    if n_sm is None:
        n_sm = _sm_count(features.device.index)
    return plan_conv(m, cin, cout, k, n_sm, n_split, fused, aligned)


def _fn(name: str):
    fn = getattr(build.load("spconv_tc" if name.endswith("_tc") else "spconv"),
                 name)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(features, inv, weights):
    if features.dim() != 2 or inv.dim() != 2 or weights.dim() != 3:
        raise ValueError(
            f"expected features (N, Cin), inv (K, M), weights (K, Cin, Cout); "
            f"got {tuple(features.shape)}, {tuple(inv.shape)}, "
            f"{tuple(weights.shape)}")
    k, m = inv.shape
    if weights.shape[:2] != (k, features.shape[1]):
        raise ValueError(
            f"weights {tuple(weights.shape)} do not match K={k}, "
            f"Cin={features.shape[1]}")
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("features and weights must be float32")
    if inv.dtype != torch.int32:
        raise TypeError(f"inv must be int32, got {inv.dtype}")


def _check_epilogue(epi: Epilogue) -> None:
    if (epi.ln_scale is None) != (epi.ln_bias is None):
        raise ValueError("Epilogue.ln_scale and ln_bias must come together")


def _kernel_device(features: torch.Tensor) -> torch.device:
    if features.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{features.device}")
    return features.device


def _device_operand(t: torch.Tensor, what: str, device, shape=None,
                    dtype=torch.float32) -> int:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch(features, inv, weights, epi: Epilogue | None, kind: str | None,
            n_split: int | None, stats: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Launch the entry (`epi` None: the sum alone) on the variant `kind`
    (None: the one `plan_conv` names), the tensor-core kernel adding to
    `stats` if given."""
    fused = epi is not None
    entry = "spconv_fod_fused" if fused else "spconv_fod"
    dev = _kernel_device(features)
    (n, cin), (k, m), cout = features.shape, inv.shape, weights.shape[2]
    if fused and cout > MAX_FUSED_COUT:
        raise ValueError(f"fused kernel takes Cout <= {MAX_FUSED_COUT}, got "
                         f"{cout}")
    ptrs = [_device_operand(features, "features", dev),
            _device_operand(inv, "inv", dev, dtype=torch.int32),
            _device_operand(weights, "weights", dev)]
    if fused:
        for t, what, shape in ((epi.bias, "bias", (cout,)),
                               (epi.ln_scale, "ln_scale", (cout,)),
                               (epi.ln_bias, "ln_bias", (cout,)),
                               (epi.residual, "residual", (m, cout)),
                               (epi.mask, "mask", (m,))):
            ptrs.append(None if t is None
                        else _device_operand(t, what, dev, shape))
    if kind == "fma":
        if n_split not in (None, 1):
            raise ValueError("the FMA kernel does not split")
        plan = None
    else:
        plan = plan_for(features, inv, weights, fused=fused, n_split=n_split,
                        bias=epi.bias if fused else None,
                        residual=epi.residual if fused else None)
        if kind is not None and plan.variant != kind:
            raise ValueError(f"variant {plan.variant!r} takes these operands "
                             f"(Cin {cin}, Cout {cout}), not {kind!r}")
        kind = plan.variant
    if stats is not None and kind != "tc":
        raise ValueError("only the tensor-core kernel keeps device counts")
    stats_ptr = None if stats is None else _device_operand(
        stats, "stats", dev, (len(STATS),), torch.int32)
    out = torch.empty((m, cout), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    shape = [n, cin, k, m, cout] + ([int(bool(epi.relu))] if fused else [])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind == "tc":
        err = _fn(entry + "_tc")(*ptrs, out.data_ptr(), *shape, plan.n_split,
                                 plan.clusters, plan.cn, stats_ptr, stream)
    else:
        err = _fn(entry)(*ptrs, out.data_ptr(), *shape, stream)
    _raise_on(err, f"{entry}_{kind}")
    with _COUNT_LOCK:
        LAUNCHES[entry] += 1
        LAUNCHES[f"{entry}_{kind}"] += 1
    return out


def spconv_fod_cuda(features: torch.Tensor, inv: torch.Tensor,
                    weights: torch.Tensor, *,
                    n_split: int | None = None) -> torch.Tensor:
    """features (N, Cin) f32, inv (K, M) int32 (-1 = none), weights
    (K, Cin, Cout) f32 -> (M, Cout) f32, through the kernel `variant`
    names."""
    _check(features, inv, weights)
    if features.device.type == "cpu":
        return spconv_fod_ref(features, inv, weights)
    return _launch(features, inv, weights, None, None, n_split)


def spconv_fod_fused_cuda(features: torch.Tensor, inv: torch.Tensor,
                          weights: torch.Tensor,
                          epilogue: Epilogue | None = None, *,
                          n_split: int | None = None) -> torch.Tensor:
    """`spconv_fod_cuda` with `epilogue` (bias -> layernorm -> +residual ->
    ReLU -> *mask) applied in the kernel's flush.  Cout <= 256."""
    _check(features, inv, weights)
    epi = epilogue or Epilogue()
    _check_epilogue(epi)
    if features.device.type == "cpu":
        return spconv_fod_fused_ref(features, inv, weights, epilogue)
    return _launch(features, inv, weights, epi, None, n_split)


def spconv_fod_kernel(features: torch.Tensor, inv: torch.Tensor,
                      weights: torch.Tensor, epilogue: Epilogue | None = None,
                      *, kind: str, fused: bool, n_split: int | None = None,
                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """One entry (`fused` or not) on the variant `kind` ("tc" or "fma"),
    CUDA tensors only: raises where `variant` does not give "tc" these
    operands.  For tests and for timing one kernel beside the other.
    `stats`, an int32 tensor of len(STATS) on the card (tensor-core kernel
    only), has the kernel's own counts (`STATS`) added to it."""
    _check(features, inv, weights)
    if kind not in VARIANTS:
        raise ValueError(f"kind must be one of {VARIANTS}, got {kind!r}")
    epi = (epilogue or Epilogue()) if fused else None
    if fused:
        _check_epilogue(epi)
    return _launch(features, inv, weights, epi, kind, n_split, stats)
