"""On a card only: each hand-written CUDA kernel against its plain PyTorch
version (chip_smoke.py makes the same check at the main path's shapes).

Imports neither jax nor the reference, so it runs on a GPU host as is:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Without a CUDA device every case skips, from inside the test.

Tolerance: atol = rtol = 1e-4 — float32 sums taken in another order;
2e-2 in bfloat16 (one bf16 rounding of the output).
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.sparseconv import Epilogue
from repro_torch.kernels.spconv import ref
from repro_torch.kernels.spconv import spconv as K

TOL = dict(rtol=1e-4, atol=1e-4)


def _spconv_problem(cin, cout, k, n=700, m=500, seed=None):
    """Random inputs: 40 % of the entries -1, offset 3 all empty, rows 256
    and up empty (whole empty row tiles); m = 500 is no multiple of 64."""
    rng = np.random.default_rng(cin + cout + k if seed is None else seed)
    inv = rng.integers(-1, n, size=(k, m)).astype(np.int32)
    inv[rng.random((k, m)) < 0.4] = -1
    inv[3] = -1                               # one all-empty offset
    inv[:, 256:] = -1                         # all-empty row tiles

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    feats = dev(rng.normal(size=(n, cin)))
    w = dev(rng.normal(size=(k, cin, cout)) * 0.2)
    epi = Epilogue(bias=dev(rng.normal(size=cout)),
                   ln_scale=dev(rng.normal(size=cout)),
                   ln_bias=dev(rng.normal(size=cout)), relu=True,
                   mask=dev(rng.random(m) > 0.3),
                   residual=dev(rng.normal(size=(m, cout))))
    return feats, torch.from_numpy(inv).cuda(), w, epi


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,k", [(5, 7, 27), (4, 32, 27),
                                        (128, 96, 27), (256, 256, 8),
                                        (300, 300, 27)])
def test_cuda_kernels_match_plain_versions(cin, cout, k):
    """The public wrappers, through the variant `variant` names (odd Cin or
    Cout: the FMA kernel; whole 16-byte rows: the tensor-core kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    feats, inv_t, w, epi = _spconv_problem(cin, cout, k)
    kind = K.variant(cin, cout, k, fused=False)
    assert kind == ("fma" if cin % 4 or cout % 4 else "tc")
    before = dict(K.LAUNCHES)
    got = K.spconv_fod_cuda(feats, inv_t, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.spconv_fod_ref(feats, inv_t, w),
                               **TOL)
    assert K.LAUNCHES["spconv_fod"] == before["spconv_fod"] + 1
    assert K.LAUNCHES[f"spconv_fod_{kind}"] == before[f"spconv_fod_{kind}"] + 1
    if cout > K.MAX_FUSED_COUT:
        with pytest.raises(ValueError, match="Cout <= 256"):
            K.spconv_fod_fused_cuda(feats, inv_t, w)
        return
    got = K.spconv_fod_fused_cuda(feats, inv_t, w, epi)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ref.spconv_fod_fused_ref(feats, inv_t, w, epi), **TOL)
    assert K.LAUNCHES["spconv_fod_fused"] == before["spconv_fod_fused"] + 1
    assert K.LAUNCHES[f"spconv_fod_fused_{kind}"] == \
        before[f"spconv_fod_fused_{kind}"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [4, 384])
@pytest.mark.parametrize("cout", [32, 64, 96, 128, 256, 300])
def test_tensor_core_spconv_matches_plain_versions_at_every_split(cin, cout):
    """Every Cout instance (300: two Cout tiles, unfused only), the stem's
    Cin 4 and the widest Cin, every forced n_split 1..8 and the planned one,
    with an empty offset, empty row tiles and a ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    feats, inv_t, w, epi = _spconv_problem(cin, cout, 27)
    want = ref.spconv_fod_ref(feats, inv_t, w)
    want_f = (ref.spconv_fod_fused_ref(feats, inv_t, w, epi)
              if cout <= K.MAX_FUSED_COUT else None)
    for n_split in (None, *range(1, K.MAX_SPLIT + 1)):
        before = dict(K.LAUNCHES)
        got = K.spconv_fod_kernel(feats, inv_t, w, kind="tc", fused=False,
                                  n_split=n_split)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL,
                                   msg=lambda e: f"n_split {n_split}: {e}")
        assert K.LAUNCHES["spconv_fod_tc"] == before["spconv_fod_tc"] + 1
        if want_f is None:
            continue
        got = K.spconv_fod_kernel(feats, inv_t, w, epi, kind="tc", fused=True,
                                  n_split=n_split)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want_f, **TOL,
                                   msg=lambda e: f"n_split {n_split}: {e}")
        assert K.LAUNCHES["spconv_fod_fused_tc"] == \
            before["spconv_fod_fused_tc"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("live_rows", [60000, 700])
@pytest.mark.parametrize("n_split", [None, 1, 3, 8])
def test_tensor_core_spconv_rounds_over_many_tiles(live_rows, n_split):
    """More row tiles than clusters (938 tiles; 66 clusters of 8 on an
    H100): clusters take several live tiles in rounds, alone or split as
    the live tiles allow; with only the first 700 rows live (a padded
    level) most tiles are written as epilogue(0) by the scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    m = 60000
    feats, _, w, epi = _spconv_problem(32, 96, 27, n=30000, m=m, seed=7)
    rng = np.random.default_rng(8)
    inv = rng.integers(0, 30000, size=(27, m)).astype(np.int32)
    inv[rng.random(inv.shape) < 0.6] = -1
    inv[:, live_rows:] = -1
    inv_t = torch.from_numpy(inv).cuda()
    plan = K.plan_for(feats, inv_t, w, fused=True, n_split=n_split)
    assert plan.variant == "tc" and plan.clusters < -(-m // 64)
    for fused in (False, True):
        got = K.spconv_fod_kernel(feats, inv_t, w, epi if fused else None,
                                  kind="tc", fused=fused, n_split=n_split)
        torch.cuda.synchronize()
        want = (ref.spconv_fod_fused_ref(feats, inv_t, w, epi) if fused
                else ref.spconv_fod_ref(feats, inv_t, w))
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("live_tiles", [9, 33, 600])
def test_tensor_core_spconv_device_counts_follow_the_round_rule(live_tiles):
    """The kernel's own counts (`stats=`) on a padded level (M = 65536)
    whose first `live_tiles` row tiles have every offset on every row:
    cluster c holds live tiles c, c + G, ...; every rank of a cluster that
    holds one runs stages (`round_groups`); each (tile, offset) runs its
    one stage (Cin 32) on one rank; a cluster takes its tiles in
    ceil(held / n_split) rounds (600 tiles: two)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    m, k, n = 65536, 27, 4000
    rng = np.random.default_rng(9)
    feats = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, 32, 256)) * 0.2)
                         .astype(np.float32))
    inv = np.full((k, m), -1, np.int32)
    rows = live_tiles * K.ROWS_PER_CTA
    inv[:, :rows] = rng.integers(0, n, size=(k, rows))
    feats, w, inv_t = feats.cuda(), w.cuda(), torch.from_numpy(inv).cuda()
    plan = K.plan_for(feats, inv_t, w, fused=True)
    assert plan.variant == "tc" and plan.n_split == 8
    held = [len(range(c, live_tiles, plan.clusters))
            for c in range(plan.clusters)]
    counts = torch.zeros(len(K.STATS), dtype=torch.int32, device="cuda")
    got = K.spconv_fod_kernel(feats, inv_t, w, kind="tc", fused=True,
                              stats=counts)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ref.spconv_fod_fused_ref(feats, inv_t, w, None), **TOL)
    counts = dict(zip(K.STATS, counts.tolist()))
    assert counts["busy_ctas"] == sum(
        sum(s for _, s in K.round_groups(h, plan.n_split)) for h in held if h)
    assert counts["stages"] == live_tiles * k
    assert counts["max_rounds"] == max(-(-h // plan.n_split) for h in held)
    assert counts["stages"] >= counts["max_stages"] >= -(-k // plan.n_split)


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["features", "weights", "residual"])
def test_unaligned_spconv_operand_takes_the_fma_kernel(operand):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    feats, inv_t, w, epi = _spconv_problem(32, 64, 27)
    t = {"features": feats, "weights": w, "residual": epi.residual}[operand]
    shifted = torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
    shifted.copy_(t)
    if operand == "features":
        feats = shifted
    elif operand == "weights":
        w = shifted
    else:
        epi = epi._replace(residual=shifted)
    assert K.plan_for(feats, inv_t, w, fused=True,
                      residual=epi.residual).variant == "fma"
    before = dict(K.LAUNCHES)
    got = K.spconv_fod_fused_cuda(feats, inv_t, w, epi)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, ref.spconv_fod_fused_ref(feats, inv_t, w, epi), **TOL)
    assert K.LAUNCHES["spconv_fod_fused_fma"] == \
        before["spconv_fod_fused_fma"] + 1
    with pytest.raises(ValueError, match="variant 'fma'"):
        K.spconv_fod_kernel(feats, inv_t, w, epi, kind="tc", fused=True)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_spconv_kernel_replays_in_a_cuda_graph_with_new_maps(fused):
    """The launch is planned from shapes only: a captured call replays with
    inv changed on the device and matches the plain version at the new
    maps (n_split 8, the level-4 plan, and the planned split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    feats, inv_t, w, epi = _spconv_problem(256, 256, 27, n=600, m=534)
    _, inv_b, _, _ = _spconv_problem(256, 256, 27, n=600, m=534, seed=5)
    inv_b[:, -40:] = torch.arange(40, dtype=torch.int32, device="cuda")
    for n_split in (None, 8):
        def call():
            if fused:
                return K.spconv_fod_fused_cuda(feats, inv_t, w, epi,
                                               n_split=n_split)
            return K.spconv_fod_cuda(feats, inv_t, w, n_split=n_split)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()                                 # warm-up: build, load
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        saved = inv_t.clone()
        for maps in (saved, inv_b):
            inv_t.copy_(maps)
            graph.replay()
            torch.cuda.synchronize()
            want = (ref.spconv_fod_fused_ref(feats, inv_t, w, epi) if fused
                    else ref.spconv_fod_ref(feats, inv_t, w))
            torch.testing.assert_close(out, want, **TOL)
        inv_t.copy_(saved)


@pytest.mark.gpu
def test_spconv_launches_from_two_threads_all_count_and_agree():
    """Two router workers dispatch from their own threads on one card: the
    fused wrapper called from two live threads at once gives the plain
    result every time, and the launch counts (kept under the count lock)
    lose none."""
    import threading
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    feats, inv_t, w, epi = _spconv_problem(32, 64, 27)
    want = ref.spconv_fod_fused_ref(feats, inv_t, w, epi)
    K.spconv_fod_fused_cuda(feats, inv_t, w, epi)      # library loaded
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    outs, errors, start = [[], []], [], threading.Barrier(2)

    def worker(i):
        try:
            start.wait()
            for _ in range(50):
                outs[i].append(K.spconv_fod_fused_cuda(feats, inv_t, w, epi))
            torch.cuda.synchronize()
        except BaseException as e:     # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for got in outs[0] + outs[1]:
        torch.testing.assert_close(got, want, **TOL)
    assert K.LAUNCHES["spconv_fod_fused"] - before["spconv_fod_fused"] == 100
    assert K.LAUNCHES["spconv_fod_fused_tc"] - \
        before["spconv_fod_fused_tc"] == 100


def _mlp_operands(widths, n, dtype, seed=None):
    rng = np.random.default_rng(sum(widths) + n if seed is None else seed)
    dt = getattr(torch, dtype)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    x = dev(rng.normal(size=(n, widths[0])))
    ws = [dev(rng.normal(size=(a, b)) / np.sqrt(a))
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [dev(rng.normal(size=b) * 0.1) for b in widths[1:]]
    return x, ws, bs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths,final_act,n,variant", [
    # the six PointNet++(s) groups on the resident route (1000 rows: not a
    # multiple of any row tile)
    ([3, 32, 32, 64], True, 1000, "tc"), ([67, 64, 64, 128], True, 1000, "tc"),
    ([192, 128], True, 1000, "tc"), ([128, 64], True, 1000, "tc"),
    ([64, 64, 64], True, 1000, "tc"), ([64, 64, 13], False, 1000, "tc"),
    ([64, 64, 13], True, 1000, "tc"),
    # ragged row counts
    ([3, 32, 32, 64], True, 1, "tc"), ([67, 64, 64, 128], True, 63, "tc"),
    ([64, 64, 13], False, 65, "tc"), ([256, 7], False, 8, "tc"),
    # weights over the budget: streamed (one layer split over grid y; three)
    ([128, 1024], True, 1000, "tc_stream"), ([1024, 512], True, 1000, "tc_stream"),
    ([1024, 512, 256, 40], False, 1000, "tc_stream"),
    ([128, 1024], False, 65, "tc_stream"),
    # one layer at few rows: K split over a cluster
    ([1024, 512], True, 8, "few_rows"), ([1024, 512], False, 1, "few_rows"),
    ([256, 40], False, 15, "few_rows"), ([67, 256], True, 8, "few_rows")])
def test_fused_mlp_kernel_matches_plain_version(widths, final_act, n, variant,
                                                dtype):
    """Each route of `plan_mlp` against the plain version; the launch moves
    "fused_mlp" and the variant's count by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.fused_mlp import fused_mlp as F
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    x, ws, bs = _mlp_operands(widths, n, dtype)
    assert F.plan_for(x, ws, bs).variant == variant
    before = dict(F.LAUNCHES)
    got = F.fused_mlp_cuda(x, ws, bs, final_act)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (n, widths[-1])
    torch.testing.assert_close(got.float(),
                               fused_mlp_ref(x, ws, bs, final_act).float(),
                               **_tol(dtype))
    assert F.LAUNCHES["fused_mlp"] == before["fused_mlp"] + 1
    assert F.LAUNCHES[f"fused_mlp_{variant}"] == \
        before[f"fused_mlp_{variant}"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["tc", "fma"])
@pytest.mark.parametrize("widths,n", [
    ([3, 32, 32, 64], 1000), ([67, 64, 64, 128], 1000), ([192, 128], 1000),
    ([128, 64], 1000), ([64, 64, 64], 1000), ([64, 64, 13], 1000)])
def test_fused_mlp_forced_kind_matches_plain_version(widths, n, kind, dtype):
    """`fused_mlp_kernel(kind=...)`: the resident route and the FMA kernel
    at the PointNet++(s) widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.fused_mlp import fused_mlp as F
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    x, ws, bs = _mlp_operands(widths, n, dtype)
    final_act = widths[-1] != 13
    before = F.LAUNCHES[f"fused_mlp_{kind}"]
    got = F.fused_mlp_kernel(x, ws, bs, final_act, kind=kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               fused_mlp_ref(x, ws, bs, final_act).float(),
                               **_tol(dtype))
    assert F.LAUNCHES[f"fused_mlp_{kind}"] == before + 1


@pytest.mark.gpu
def test_unaligned_fused_mlp_operand_takes_the_fma_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.fused_mlp import fused_mlp as F
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    x, ws, bs = _mlp_operands([67, 64, 64, 128], 1000, "float32")
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    assert F.plan_for(shifted, ws, bs).variant == "fma"
    before = F.LAUNCHES["fused_mlp_fma"]
    got = F.fused_mlp_cuda(shifted, ws, bs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_mlp_ref(x, ws, bs), **TOL)
    assert F.LAUNCHES["fused_mlp_fma"] == before + 1
    with pytest.raises(ValueError, match="variant 'fma'"):
        F.fused_mlp_kernel(shifted, ws, bs, kind="tc")


@pytest.mark.gpu
@pytest.mark.parametrize("widths,n", [([67, 64, 64, 128], 1000),
                                      ([128, 1024], 1000), ([1024, 512], 8)])
def test_fused_mlp_kernel_replays_in_a_cuda_graph_with_new_x(widths, n):
    """Planned from shapes only: a captured call (resident, streamed and
    few-row routes) replays with new values in x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.fused_mlp import fused_mlp as F
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    x, ws, bs = _mlp_operands(widths, n, "float32")
    x_b, _, _ = _mlp_operands(widths, n, "float32", seed=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        F.fused_mlp_cuda(x, ws, bs)              # warm-up: build, load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = F.fused_mlp_cuda(x, ws, bs)
    for values in (x.clone(), x_b):
        x.copy_(values)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, fused_mlp_ref(x, ws, bs), **TOL)


def _cuda(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(
        np.asarray(rng.normal(size=shape) * scale, np.float32)).to(
        "cuda", getattr(torch, dtype))


def _tol(dtype):
    return TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,g,sq,skv,causal,window,softcap,bf16_kind", [
    (64, 2, 512, 512, True, None, None, "wgmma"),   # the LM prefill's class
    (64, 1, 300, 300, True, None, None, "wgmma"),   # odd S: ragged tiles
    (128, 4, 200, 333, False, None, 30.0, "wgmma"),  # cross lengths, softcap
    (256, 2, 190, 190, True, 50, None, "wgmma"),    # sliding window, widest
    (8, 8, 70, 70, True, 16, 20.0, "fma"),          # head_dim 8
    (64, 2, 300, 500, True, None, None, "wgmma"),   # Sq < Skv, causal
    (64, 2, 333, 150, False, None, None, "wgmma"),  # Sq > Skv
    (64, 2, 400, 400, True, 20, None, "wgmma"),     # window < a kv tile
    # 128 positions a CTA: the second warpgroup's rows are all masked in
    # the CTA's first kv tile, before their first real key
    (64, 1, 384, 384, True, 10, None, "wgmma"),
    (192, 8, 130, 130, True, None, 50.0, "wgmma"),
    (96, 2, 100, 100, True, None, None, "fma")])    # not whole 128-byte rows
def test_flash_attention_kernel_matches_plain_version(hd, g, sq, skv, causal,
                                                      window, softcap,
                                                      bf16_kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention as F
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(hd + sq)
    q = _cuda(rng, (2, 2 * g, sq, hd), dtype)
    k = _cuda(rng, (2, 2, skv, hd), dtype)
    v = _cuda(rng, (2, 2, skv, hd), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    kind = bf16_kind if dtype == "bfloat16" else "fma"
    assert F.variant(q.dtype, hd, g, [t.data_ptr() % 16 for t in
                                      (q, k, v)]) == kind
    before = dict(F.LAUNCHES)
    got = F.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, **kw).float(),
                               **_tol(dtype))
    assert F.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert F.LAUNCHES[f"flash_attention_{kind}"] == \
        before[f"flash_attention_{kind}"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_flash_attention_unaligned_operand_takes_the_fma_kernel(operand):
    """A bf16 operand 2 bytes off a 16-byte boundary cannot be a TMA source:
    the call takes the FMA kernel and stays right; the tensor-core entry
    point refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention as F
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(5)
    shapes = {"q": (2, 4, 200, 64), "k": (2, 2, 200, 64), "v": (2, 2, 200, 64)}
    ops = {}
    for name, shape in shapes.items():
        off = 1 if name == operand else 0
        flat = _cuda(rng, (int(np.prod(shape)) + off,), "bfloat16")
        ops[name] = flat[off:].view(shape)
    q, k, v = ops["q"], ops["k"], ops["v"]
    assert ops[operand].data_ptr() % 16 == 2
    before = dict(F.LAUNCHES)
    got = F.flash_attention_cuda(q, k, v, window=70)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, window=70).float(),
                               **_tol("bfloat16"))
    assert F.LAUNCHES["flash_attention_fma"] == \
        before["flash_attention_fma"] + 1
    assert F.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    with pytest.raises(ValueError, match="tensor-core kernel"):
        F.flash_attention_wgmma(q, k, v)


def _decode_lengths(s):
    """Unequal lengths: empty, one slot, around a 64-slot boundary, half,
    full, and one past the cache (the kernel clamps it to S)."""
    return [0, 1, min(63, s), min(64, s), min(65, s), s // 2 + 3, s, s + 7]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
@pytest.mark.parametrize("hd,g,s,softcap", [
    (64, 2, 1024, None), (128, 4, 301, 30.0), (256, 1, 77, None),
    (36, 2, 200, None),                      # 72-byte bf16 rows: 8-byte loads
    (64, 8, 130, 20.0)])                     # two head groups a kv head
def test_flash_decode_kernel_matches_plain_version(hd, g, s, softcap, q_dtype,
                                                   kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import flash_decode as F
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    rng = np.random.default_rng(hd + s)
    lens = _decode_lengths(s)
    b, hkv = len(lens), 2
    q = _cuda(rng, (b, hkv * g, hd), q_dtype)
    k = _cuda(rng, (b, s, hkv, hd), kv_dtype)
    v = _cuda(rng, (b, s, hkv, hd), kv_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = flash_decode_ref(q, k, v, lengths, softcap=softcap)
    tol = _tol("bfloat16" if "bfloat16" in (q_dtype, kv_dtype) else
               "float32")
    before = F.LAUNCHES["flash_decode"]
    splits = [None] + list(range(1, F.MAX_SPLIT + 1))   # planned, then each
    for n_split in splits:
        got = F.flash_decode_cuda(q, k, v, lengths, softcap=softcap,
                                  n_split=n_split)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **tol)
        # an empty sequence reads nothing and writes zeros, as the Pallas
        # kernel does
        assert bool((got[0] == 0).all())
    assert F.LAUNCHES["flash_decode"] == before + len(splits)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,kv_dtype", [(64, "bfloat16"), (36, "bfloat16"),
                                         (128, "float32")])
def test_flash_decode_kernel_matches_split_plain_version(hd, kv_dtype):
    """At each forced split the kernel equals `flash_decode_split_ref` at
    that split (the chunk rule taken from the same launch plan), lengths
    that leave chunks empty included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import flash_decode as F
    from repro_torch.kernels.flash_decode.ref import flash_decode_split_ref
    rng = np.random.default_rng(hd)
    s, hkv, g = 300, 2, 2
    lens = _decode_lengths(s)
    b = len(lens)
    q = _cuda(rng, (b, hkv * g, hd), "float32")
    k = _cuda(rng, (b, s, hkv, hd), kv_dtype)
    v = _cuda(rng, (b, s, hkv, hd), kv_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for n_split in range(1, F.MAX_SPLIT + 1):
        got = F.flash_decode_cuda(q, k, v, lengths, softcap=30.0,
                                  n_split=n_split)
        want = flash_decode_split_ref(q, k, v, lengths, n_split, softcap=30.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **_tol("float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("offset,vec", [(0, 16), (1, 2), (4, 8)])
def test_flash_decode_kernel_takes_unaligned_caches(offset, vec):
    """A cache view `offset` bf16 elements into its storage takes the
    widest load its alignment allows, in the same kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import flash_decode as F
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    rng = np.random.default_rng(offset)
    b, hkv, g, s, hd = 4, 8, 2, 300, 64
    q = _cuda(rng, (b, hkv * g, hd), "bfloat16")
    n = b * s * hkv * hd
    k, v = (_cuda(rng, (n + offset,), "bfloat16")[offset:].view(
        b, s, hkv, hd) for _ in range(2))
    lengths = torch.tensor([s, 5, 0, 170], dtype=torch.int32, device="cuda")
    plan = F.plan_launch(q, k, v, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert plan.vec == vec
    got = F.flash_decode_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               flash_decode_ref(q, k, v, lengths).float(),
                               **_tol("bfloat16"))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_reads_nothing_past_lengths(kv_dtype):
    """Slots at and past len_b hold NaN: the kernel's output is finite and
    equals the plain version on the same cache with those slots zeroed (the
    plain version itself multiplies p = 0 by NaN there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import flash_decode as F
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    rng = np.random.default_rng(11)
    s, hkv, g, hd = 512, 8, 2, 64
    lens = _decode_lengths(s)
    b = len(lens)
    q = _cuda(rng, (b, hkv * g, hd), "bfloat16")
    k = _cuda(rng, (b, s, hkv, hd), kv_dtype)
    v = _cuda(rng, (b, s, hkv, hd), kv_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    past = torch.arange(s, device="cuda")[None, :] >= lengths[:, None]
    k_nan = k.masked_fill(past[:, :, None, None], float("nan"))
    v_nan = v.masked_fill(past[:, :, None, None], float("nan"))
    want = flash_decode_ref(q, k.masked_fill(past[:, :, None, None], 0),
                            v.masked_fill(past[:, :, None, None], 0), lengths)
    for n_split in (None, 1, 3, 8):
        got = F.flash_decode_cuda(q, k_nan, v_nan, lengths, n_split=n_split)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(),
                                   **_tol("bfloat16"))


@pytest.mark.gpu
def test_flash_decode_kernel_replays_in_a_cuda_graph_with_new_lengths():
    """No host read of `lengths`: a captured call replays with lengths
    changed on the device and matches the plain version at the new ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_decode import flash_decode as F
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    rng = np.random.default_rng(12)
    b, s, hkv, g, hd = 8, 1024, 8, 2, 64
    q = _cuda(rng, (b, hkv * g, hd), "bfloat16")
    k = _cuda(rng, (b, s, hkv, hd), "bfloat16")
    v = _cuda(rng, (b, s, hkv, hd), "bfloat16")
    lengths = torch.full((b,), 513, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        F.flash_decode_cuda(q, k, v, lengths)      # warm-up: build, load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = F.LAUNCHES["flash_decode"]
    with torch.cuda.graph(graph):
        out = F.flash_decode_cuda(q, k, v, lengths)
    assert F.LAUNCHES["flash_decode"] == before + 1
    for lens in ([513] * b, [0, 1, 64, 65, 700, 1024, 2000, 7]):
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), flash_decode_ref(q, k, v, lengths).float(),
            **_tol("bfloat16"))
    assert F.LAUNCHES["flash_decode"] == before + 1   # a replay skips Python


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row_tile,eids,cin,cout", [
    (128, [3, 3, 0, 5, 1, 1, 1, 2], 1024, 512),   # unequal segments
    (64, [2, 0, 2, 7, 7], 200, 300),             # odd widths, revisits
    (128, [0], 512, 1024),
    # K and N tails (200 = 3 x 64 + 8, 136 = 128 + 8); experts 6 and 0 come
    # before others, so a K tail read past their Cin rows would show
    (128, [6, 7, 0, 7, 2, 6], 200, 136),
    (256, [1, 9, -3, 7], 256, 128)])             # ids out of range
def test_grouped_matmul_kernel_matches_plain_version(row_tile, eids, cin, cout,
                                                     dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.grouped_matmul import grouped_matmul as F
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    rng = np.random.default_rng(cin + cout)
    x = _cuda(rng, (row_tile * len(eids), cin), dtype)
    w = _cuda(rng, (8, cin, cout), dtype, scale=cin ** -0.5)
    eid = torch.tensor(eids, dtype=torch.int32, device="cuda")
    # bf16 at widths that are multiples of 8 and 128-row tiles takes the
    # tensor cores; float32 and odd widths the float32-FMA kernel
    kind = "wgmma" if dtype == "bfloat16" and cout != 300 else "fma"
    assert F.variant(x.dtype, cin, cout, row_tile) == kind
    before = dict(F.LAUNCHES)
    got = F.grouped_matmul_cuda(x, eid, w, row_tile)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (x.shape[0], cout)
    # ids out of range take the reference's rule (jnp indexing): a negative
    # id wraps once (+E), then the id clamps to [0, E - 1]: 9 -> 7, -3 -> 5
    e = w.shape[0]
    ref_eid = torch.where(eid < 0, eid + e, eid).clamp(0, e - 1)
    want = grouped_matmul_ref(x, ref_eid, w, row_tile)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    moved = {k: F.LAUNCHES[k] - before[k] for k in before}
    assert moved == {"grouped_matmul": 1,
                     "grouped_matmul_wgmma": int(kind == "wgmma"),
                     "grouped_matmul_fma": int(kind == "fma"),
                     "grouped_matmul_dx": 0, "grouped_matmul_dw": 0,
                     "grouped_matmul_dw_wgmma": 0, "grouped_matmul_dw_fma": 0}
    if kind == "wgmma":   # the FMA kernel still takes these shapes
        fma = F.grouped_matmul_fma(x, eid, w, row_tile)
        torch.testing.assert_close(fma.float(), want.float(), **_tol(dtype))
    else:                 # the tensor-core kernel refuses them
        with pytest.raises(ValueError):
            F.grouped_matmul_wgmma(x, eid, w, row_tile)


def _windowed_decode_inputs(s_cache, window, positions):
    """Seeded inputs of one decode step of a reduced granite attention
    layer, drawn exactly as tests/test_torch_lm_kernels.py
    `test_decode_attention_matches_reference_masked_path` draws them (that
    test holds the CPU call to the reference's on them)."""
    rng = np.random.default_rng(s_cache + (window or 0))
    from repro_torch.configs import get
    cfg = get("granite-moe-1b-a400m", reduced=True)
    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    h = cfg.n_heads
    params = {n: {"w": rng.normal(size=shape) / np.sqrt(shape[0])}
              for n, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                               ("wv", (d, hkv * hd)), ("wo", (h * hd, d)))}
    x = rng.normal(size=(2, 1, d))
    k = rng.normal(size=(2, s_cache, hkv, hd))
    v = rng.normal(size=(2, s_cache, hkv, hd))
    return cfg, params, x, k, v, np.array(positions, np.int32)


def _windowed_decode(cfg, params, x, k, v, pos, window, device):
    from repro_torch.models import layers as TL

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)
    tp = {n: {"w": t(p["w"])} for n, p in params.items()}
    cache = TL.KVCache(t(k), t(v))
    out, cache = TL.attention_apply(
        tp, cfg, t(x), t(pos[:, None], torch.int64), layer_window=window,
        mode="decode", cache=cache, cache_pos=t(pos, torch.int64))
    return out, cache


@pytest.mark.gpu
@pytest.mark.parametrize("s_cache,window,positions", [
    (16, 4, [2, 9]), (64, 16, [5, 40])])
def test_windowed_decode_over_a_longer_cache_runs_on_the_card(
        s_cache, window, positions):
    """A window shorter than a plain cache: the valid slots are no prefix,
    so the layer takes the masked decode path on the card as on the CPU
    (the reference has no kernel here).  f32, within 1e-5 x max|plain| of
    the same call on the CPU, which tests/test_torch_lm_kernels.py holds
    to the reference's on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params, x, k, v, pos = _windowed_decode_inputs(s_cache, window,
                                                        positions)
    got, gcache = _windowed_decode(cfg, params, x, k, v, pos, window, "cuda")
    want, wcache = _windowed_decode(cfg, params, x, k, v, pos, window, "cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
    # the slot written this step holds the new K/V (projected on each
    # device: float32 sums in another order), the rest is untouched
    for g, w in ((gcache.k.cpu(), wcache.k), (gcache.v.cpu(), wcache.v)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def _dw_check(got, x, dy, eid, e, row_tile, dtype):
    """got against the plain version: float32 sums (1e-4 of max|plain| at
    f32; bf16 output: 2e-2), zeros for an expert without tiles.  Returns
    the error over max|plain|."""
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_dw_ref
    want = grouped_matmul_dw_ref(x, dy, eid, e, row_tile)
    assert got.dtype == x.dtype and got.shape == want.shape
    tol = 1e-4 if dtype == "float32" else 2e-2
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)
    owned = {min(max(i + e if i < 0 else i, 0), e - 1)
             for i in eid.tolist()}
    for k in set(range(e)) - owned:
        assert not got[k].any()
    return err / scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row_tile,eids,cin,cout", [
    (128, [0, 1, 1, 3, 3, 3], 1024, 512),      # an expert with no tile
    (16, [2, -1, 9, 0, 0], 70, 130),           # odd widths, ids out of range
    (64, [5, 5, 5], 64, 64),
    (64, [1, 0, 1, 2, 1], 512, 256),           # expert 1's tiles apart
    # tails (200 = 128 + 72 channels, 136 = 128 + 8 columns); ids out of
    # range: -2 wraps to 4, 11 clamps to 5; experts 0-3 own nothing
    (128, [4, -2, 11, 4], 200, 136),
    (64, [-1, 3, 3, -7, 0], 8, 264)])          # -1 -> 5, -7 -> 0; Cin 8
def test_grouped_matmul_dw_kernel_matches_plain_version(row_tile, eids, cin,
                                                        cout, dtype,
                                                        record_property):
    """The weight-gradient kernel that `dw_variant` names against its plain
    version (bf16 with widths of 8 and 64-row tiles: the tensor-core
    kernel; the rest: the FMA kernel), with the per-variant launch count;
    the FMA kernel takes every shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
    rng = np.random.default_rng(len(eids) + cin)
    dt = getattr(torch, dtype)
    r, e = len(eids) * row_tile, 6
    x = torch.from_numpy(rng.normal(size=(r, cin)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(r, cout)).astype(np.float32))
    x, dy = x.to("cuda", dt), dy.to("cuda", dt)
    eid = torch.tensor(eids, dtype=torch.int32, device="cuda")
    kind = "wgmma" if dtype == "bfloat16" and row_tile % 64 == 0 and \
        cin % 8 == 0 and cout % 8 == 0 else "fma"
    assert GM.dw_variant(dt, cin, cout, row_tile) == kind
    keys = ("grouped_matmul_dw", "grouped_matmul_dw_wgmma",
            "grouped_matmul_dw_fma")
    before = {k: GM.LAUNCHES[k] for k in keys}
    got = GM.grouped_matmul_dw_cuda(x, dy, eid, e, row_tile)
    torch.cuda.synchronize()
    assert {k: GM.LAUNCHES[k] - before[k] for k in keys} == {
        "grouped_matmul_dw": 1, "grouped_matmul_dw_wgmma": int(kind == "wgmma"),
        "grouped_matmul_dw_fma": int(kind == "fma")}
    record_property("err_over_max_plain",
                    _dw_check(got, x, dy, eid, e, row_tile, dtype))
    if row_tile % 16 == 0:
        fma = GM.grouped_matmul_dw_fma(x, dy, eid, e, row_tile)
        _dw_check(fma, x, dy, eid, e, row_tile, dtype)
    if kind == "fma":
        with pytest.raises(ValueError):
            GM.grouped_matmul_dw_wgmma(x, dy, eid, e, row_tile)


@pytest.mark.gpu
def test_grouped_matmul_dw_wgmma_over_many_tiles():
    """300 row tiles of 64 rows (more ids than a warp ballots at once, and
    more output tiles than CTAs in the persistent grid), experts drawn at
    random with ids out of range, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
    rng = np.random.default_rng(256)
    # 5 x 3 tiles of 128 x 256 an expert, 150 in all: more than the SMs;
    # 520 = 4 x 128 + 8 channels and 2 x 256 + 8 columns leave tails
    n_tiles, rt, e, cin, cout = 300, 64, 10, 520, 520
    x, dy = (torch.from_numpy(rng.normal(size=(n_tiles * rt, c)).astype(
        np.float32)).to("cuda", torch.bfloat16) for c in (cin, cout))
    eid = torch.from_numpy(rng.integers(-3, 9, n_tiles).astype(np.int32))
    eid = eid.cuda()
    got = GM.grouped_matmul_dw_wgmma(x, dy, eid, e, rt)
    torch.cuda.synchronize()
    _dw_check(got, x, dy, eid, e, rt, "bfloat16")


MOE_CARD_EXPERTS, MOE_CARD_ROW_TILE = 4, 128


def sorted_moe_card_inputs():
    """Seeded inputs of the card's sorted-MoE backward test, also held to
    `jax.grad` of the reference on the CPU (tests/test_torch_moe_backward.py):
    T 200, D 64, F 96, 4 experts, top 2, expert 3 past its capacity.
    Returns (expert_idx int32, arrays by name, cotangent float32)."""
    rng = np.random.default_rng(12)
    t, d, f, e, topk = 200, 64, 96, MOE_CARD_EXPERTS, 2
    idx = np.stack([rng.permutation(e)[:topk] for _ in range(t)])
    hot = rng.random(t) < 0.7            # expert 3 past its capacity
    idx[hot] = np.where(idx[hot] == 3, idx[hot][:, ::-1], idx[hot])
    idx[hot, 0] = 3
    gates = rng.random((t, topk))
    gates /= gates.sum(-1, keepdims=True)
    arrays = {"x": rng.normal(size=(t, d)), "gates": gates,
              "w_in": rng.normal(size=(e, d, f)) / 8,
              "w_out": rng.normal(size=(e, f, d)) / 10,
              "w_gate": rng.normal(size=(e, d, f)) / 8}
    cot = rng.normal(size=(t, d)).astype(np.float32)
    return idx.astype(np.int32), arrays, cot


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_moe_ffn_backward_on_the_card_matches_the_cpu(dtype,
                                                            record_property):
    """`sorted_moe_ffn`'s gradients for x, gates, w_in, w_gate and w_out on
    the card (the kernels, the gathers' inverse-table backward) against
    the same call on the CPU (the plain versions), with capacity drops
    and padding rows; dW through the FMA kernel at f32 and the tensor-core
    kernel at bf16.  The CPU's gradients on these inputs are held to the
    reference's `jax.grad` in tests/test_torch_moe_backward.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    idx, named, cot = sorted_moe_card_inputs()
    idx, cot = torch.from_numpy(idx), torch.from_numpy(cot)
    arrays = list(named.values())
    dt = getattr(torch, dtype)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
                  .requires_grad_() for a in arrays]
        before = dict(GM.LAUNCHES)
        out = gmm_ops.sorted_moe_ffn(leaves[0], idx.to(dev), leaves[1],
                                     leaves[2], leaves[3], w_gate=leaves[4],
                                     row_tile=MOE_CARD_ROW_TILE)
        (out.float() * cot.to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            kind = "wgmma" if dtype == "bfloat16" else "fma"
            assert GM.LAUNCHES[f"grouped_matmul_dw_{kind}"] == \
                before[f"grouped_matmul_dw_{kind}"] + 3
        grads[dev] = [leaf.grad.cpu().float() for leaf in leaves]
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, got, want in zip(named, grads["cuda"], grads["cpu"]):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        record_property(f"{name}_err_over_max_plain", err / scale)
        assert scale > 0 and err <= tol * scale, (name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_backward_on_the_card_matches_the_cpu(dtype,
                                                            record_property):
    """`ops.grouped_matmul`'s backward on the card (dX through the forward
    kernel on the transposed weights, dW through its kernel) against the
    same call on the CPU (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    rng = np.random.default_rng(9)
    dt = getattr(torch, dtype)
    eids = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    x, w, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dt) for s in ((512, 64), (4, 64, 96), (512, 96)))
    grads = {}
    for dev in ("cpu", "cuda"):
        xx = x.to(dev).detach().requires_grad_()
        ww = w.to(dev).detach().requires_grad_()
        before = dict(GM.LAUNCHES)
        gmm_ops.grouped_matmul(xx, eids.to(dev), ww, 128).backward(g.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert GM.LAUNCHES["grouped_matmul_dx"] == \
                before["grouped_matmul_dx"] + 1
            assert GM.LAUNCHES["grouped_matmul_dw"] == \
                before["grouped_matmul_dw"] + 1
        grads[dev] = (xx.grad.cpu().float(), ww.grad.cpu().float())
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, got, want in zip(("dx", "dw"), grads["cuda"], grads["cpu"]):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        record_property(f"{name}_err_over_max_plain", err / scale)
        assert err <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(window=40, softcap=30.0)])
def test_flash_attention_backward_on_the_card_matches_the_cpu(dtype, kw,
                                                              record_property):
    """`ops.flash_attention` forward through the kernel (wgmma at bf16 with
    head_dim 64, FMA at f32) and its backward (the plain version
    recomputed and differentiated) against the same call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(10)
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .to(dt) for s in ((2, 4, 200, 64), (2, 2, 200, 64),
                                    (2, 2, 200, 64), (2, 4, 200, 64)))
    res = {}
    for dev in ("cpu", "cuda"):
        qkv = [t.to(dev).detach().requires_grad_() for t in (q, k, v)]
        before = FA.LAUNCHES["flash_attention"]
        out = fa_ops.flash_attention(*qkv, **kw)
        out.backward(g.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert FA.LAUNCHES["flash_attention"] == before + 1
        res[dev] = [out.detach()] + [t.grad for t in qkv]
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, got, want in zip(("out", "dq", "dk", "dv"), res["cuda"],
                               res["cpu"]):
        got, want = got.cpu().float(), want.float()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        record_property(f"{name}_err_over_max_plain", err / scale)
        assert err <= tol * scale


@pytest.mark.gpu
def test_v1_segment_of_a_small_scene_on_the_card():
    """A small scene through an engine="v1" PointCloudEngine on the card:
    the fused kernel on every conv (13 sites of a mini-MinkUNet), labels
    equal to the same engine on the CPU (plain versions) except at near
    ties of the CPU logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.data.synthetic import lidar_scene
    from repro_torch.models import minkunet as MU
    from repro_torch.serve.buckets import geometric_ladder
    from repro_torch.serve.engine import PointCloudEngine
    module = MU.mini_minkunet_init(torch.Generator().manual_seed(0))
    coords, mask, feats = lidar_scene(3, 900, grid=24)
    coords[mask, 1] += 40000              # outside the packed-key budget
    from repro_torch.core import mapping as M
    from repro_torch.serve.buckets import pad_scene
    preds = {}
    for dev in ("cpu", "cuda"):
        eng = PointCloudEngine(module, 2, device=dev, engine="v1",
                               ladder=geometric_ladder(256, 1024))
        before = K.LAUNCHES["spconv_fod_fused_tc"]
        preds[dev], _ = eng.segment(coords, mask, feats)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert K.LAUNCHES["spconv_fod_fused_tc"] == before + 13
    # the CPU forward's logits (the plain flow over the same pyramid)
    cpu = PointCloudEngine(module, 2, device="cpu", engine="v1",
                           ladder=geometric_ladder(256, 1024))
    levels, _ = cpu.levels_for(coords, mask)
    c, m, f = pad_scene(coords, mask, feats, 1024)
    logits = MU.minkunet_apply(cpu.module, M.PointCloud(
        torch.from_numpy(c), torch.from_numpy(m), 1), torch.from_numpy(f),
        flow="fod", levels=levels)[:900]
    top2 = logits.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < 1e-4
    diff = (preds["cuda"].cpu() != preds["cpu"]) & torch.from_numpy(mask)
    assert not bool((diff & ~near).any())


# ---------------------------------------------------------------------------
# the training launcher on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_checkpoint_round_trips_bf16_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import store
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(33, 17, generator=g, device="cuda").to(
        torch.bfloat16), "n": [torch.tensor(5, dtype=torch.int32,
                                            device="cuda")]}
    store.save(str(tmp_path), 1, tree)
    assert store.read_manifest(str(tmp_path), 1)["leaves"]["w"] == {
        "shape": [33, 17], "dtype": "bfloat16"}
    like = {"w": torch.zeros_like(tree["w"]),
            "n": [torch.zeros_like(tree["n"][0])]}
    got = store.restore(str(tmp_path), 1, like)
    assert got["w"].device.type == "cuda" and got["w"].dtype == \
        torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert int(got["n"][0]) == 5


@pytest.mark.gpu
def test_prefetch_iterator_puts_batches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.data.pipeline import PrefetchIterator
    from repro_torch.data.synthetic import token_batch

    def batch_fn(step):
        return token_batch(0, step, 2, 16, 256)
    it = PrefetchIterator(batch_fn, start_step=3, device="cuda")
    got = [next(it) for _ in range(2)]
    it.close()
    assert not it._t.is_alive()
    for step, batch in got:
        for k, v in batch_fn(step).items():
            assert batch[k].device.type == "cuda"
            np.testing.assert_array_equal(batch[k].cpu().numpy(), v)
    assert [s for s, _ in got] == [3, 4]


@pytest.mark.gpu
def test_launcher_resumes_bit_equal_on_the_card(tmp_path, capsys):
    """Two steps of reduced granite-moe-1b-a400m on the card, saving after
    each; a run resumed from step 1's checkpoint computes step 1's loss
    bit-equal (the loss is a forward of the restored weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import train as TRAIN
    args = ["--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "4",
            "--seq", "32", "--lr", "1e-3", "--log-every", "1",
            "--lr-total-steps", "4", "--ckpt-every", "1"]
    runs = {"full": {}, "resumed": {}}

    def rec(name):
        return lambda step, met, stats: runs[name].update({step: met})
    TRAIN.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")],
               on_step=rec("full"))
    for sub in ("", "/opt"):
        src = tmp_path / f"a{sub}" / "step_00000001"
        dst = tmp_path / f"b{sub}" / "step_00000001"
        shutil.copytree(src, dst)
    TRAIN.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")],
               on_step=rec("resumed"))
    assert "[resume] step 1" in capsys.readouterr().out
    assert sorted(runs["resumed"]) == [1]
    assert runs["resumed"][1]["loss"] == runs["full"][1]["loss"]
    assert np.isfinite(runs["full"][0]["loss"])


@pytest.mark.gpu
def test_flash_attention_with_48_query_heads_a_kv_head_bf16():
    """granite-34b's MQA (48 query heads on one kv head, head_dim 128) at
    bf16: G is no power of two, so the FMA kernel takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention as FAK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(2, 48, 70, 128, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(2, 1, 70, 128, generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    before = FAK.LAUNCHES["flash_attention_fma"]
    got = FAK.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert FAK.LAUNCHES["flash_attention_fma"] == before + 1
    want = attention_ref(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max())


@pytest.mark.gpu
def test_minkunet_init_from_a_card_generator_is_on_the_card():
    """Every leaf follows the generator's device: the layernorm leaves were
    made on the CPU beside card-drawn convolutions before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import minkunet as MU
    module = MU.mini_minkunet_init(torch.Generator(device="cuda")
                                   .manual_seed(0))
    devices = {p.device.type for p in module.parameters()}
    assert devices == {"cuda"}
    cpu = MU.mini_minkunet_init(torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(module.state_dict().items(),
                                 cpu.state_dict().items()):
        assert a.shape == b.shape, name


@pytest.mark.gpu
def test_recurrent_lm_init_and_state_from_a_card_generator_are_on_the_card():
    """Reduced jamba (mamba, attention and MoE sub-layers) and xlstm (mLSTM
    and sLSTM): every parameter drawn from a card generator and every
    decode-state leaf lies on the card, in the dtypes asked for (the
    recurrent states' own float32 leaves aside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.models import registry
    from repro_torch.models.params import flatten_tree
    for arch in ("jamba-v0.1-52b", "xlstm-125m"):
        model = registry.build(get(arch, reduced=True))
        module = model.init(torch.Generator(device="cuda").manual_seed(0),
                            torch.bfloat16)
        assert {p.device.type for p in module.parameters()} == {"cuda"}
        assert {p.dtype for p in module.parameters()} == {torch.bfloat16}
        state = model.init_state(2, 32, torch.bfloat16)
        leaves = dict(flatten_tree(state))
        assert {x.device.type for x in leaves.values()} == {"cuda"}, arch
        assert {x.dtype for x in leaves.values()} <= {torch.bfloat16,
                                                      torch.float32}


@pytest.mark.gpu
def test_multimodal_lm_init_and_state_from_a_card_generator_are_on_the_card():
    """Reduced qwen2-vl (M-RoPE, patch embeddings) and seamless (the
    encoder-decoder, layernorm): every parameter drawn from a card
    generator and every decode-state leaf lies on the card in bf16; a
    prefill and a decode step run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get
    from repro_torch.models import registry
    from repro_torch.models.params import flatten_tree, tree_map
    for arch in ("qwen2-vl-72b", "seamless-m4t-medium"):
        cfg = get(arch, reduced=True)
        model = registry.build(cfg)
        module = model.init(torch.Generator(device="cuda").manual_seed(0),
                            torch.bfloat16)
        assert {p.device.type for p in module.parameters()} == {"cuda"}
        assert {p.dtype for p in module.parameters()} == {torch.bfloat16}
        kw = {"enc_len": 12} if cfg.family == "audio" else {}
        state = model.init_state(2, 32, torch.bfloat16, **kw)
        leaves = [x for _, x in flatten_tree(state)]
        assert {x.device.type for x in leaves} == {"cuda"}, arch
        assert {x.dtype for x in leaves} == {torch.bfloat16}, arch
        tok = torch.zeros((2, 8), dtype=torch.int64, device="cuda")
        if cfg.family == "audio":
            batch = {"frame_embeds": torch.randn(2, 12, cfg.d_model,
                                                 device="cuda"),
                     "enc_positions": torch.arange(12, device="cuda")
                     .expand(2, 12),
                     "tokens": tok,
                     "positions": torch.arange(8, device="cuda").expand(2, 8)}
            step_pos = torch.full((2, 1), 8, device="cuda")
        else:
            batch = {"tokens": tok,
                     "patch_embeds": torch.randn(2, 4, cfg.d_model,
                                                 device="cuda"),
                     "positions": torch.arange(12, device="cuda")[:, None]
                     .expand(2, 12, 3)}
            step_pos = torch.full((2, 1, 3), 12, device="cuda")
        with torch.no_grad():
            logits, pre, _ = model.prefill(module, batch)
            n = logits.shape[1]

            def place(dst, src):
                dst[tuple(slice(0, m) for m in src.shape)].copy_(src)
                return dst
            tree_map(place, state, pre)
            out, _, _ = model.decode(module, {
                "tokens": tok[:, :1], "positions": step_pos,
                "cache_pos": torch.full((2,), n, device="cuda")}, state)
        assert out.shape == (2, 1, cfg.vocab_size) and out.is_cuda
        assert bool(out.float().isfinite().all()), arch


@pytest.mark.gpu
@pytest.mark.parametrize("hd,g,hkv,sq,b", [
    (128, 8, 8, 1024, 2),     # qwen2-vl's prefill: 64 query heads a layer
    (64, 1, 16, 256, 4)])     # seamless's decoder self-attention
def test_multimodal_attention_instances_match_plain_versions(hd, g, hkv, sq,
                                                             b):
    """The flash_attention_wgmma instance (causal, bf16) and the
    flash_decode instance of each new path's decode step, at the paths'
    head layout, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    rng = np.random.default_rng(hd + g)
    q = _cuda(rng, (b, hkv * g, sq, hd), "bfloat16")
    k = _cuda(rng, (b, hkv, sq, hd), "bfloat16")
    v = _cuda(rng, (b, hkv, sq, hd), "bfloat16")
    assert FA.variant(q.dtype, hd, g, [t.data_ptr() % 16 for t in
                                       (q, k, v)]) == "wgmma"
    before = FA.LAUNCHES["flash_attention_wgmma"]
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(),
                               **_tol("bfloat16"))
    assert FA.LAUNCHES["flash_attention_wgmma"] == before + 1
    s = sq + 16
    qd = _cuda(rng, (b, hkv * g, hd), "bfloat16")
    kc = _cuda(rng, (b, s, hkv, hd), "bfloat16")
    vc = _cuda(rng, (b, s, hkv, hd), "bfloat16")
    lengths = torch.full((b,), sq + 5, dtype=torch.int32, device="cuda")
    before = FD.LAUNCHES["flash_decode"]
    got = FD.flash_decode_cuda(qd, kc, vc, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), flash_decode_ref(qd, kc, vc, lengths).float(),
        **_tol("bfloat16"))
    assert FD.LAUNCHES["flash_decode"] == before + 1
