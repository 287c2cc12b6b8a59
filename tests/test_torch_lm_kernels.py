"""Port parity of the LM kernels' plain versions and of the MoE dispatch,
against the reference's oracles and its Pallas kernels in interpret mode.

Inputs come from numpy seeds.  Floats: atol = rtol = 1e-4 at float32
(sums in another order), 2e-2 at bfloat16 (one bf16 rounding of the
output).  Integers (`make_dispatch`, `route`'s expert indices): equal.
On the CPU each kernel wrapper takes its plain version and counts no
launch, so `ops.*` here run the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as r_attention
from repro.kernels.flash_decode.flash_decode import flash_decode_pallas
from repro.kernels.flash_decode.ref import flash_decode_ref as r_decode
from repro.kernels.grouped_matmul import ops as r_gmm
from repro.kernels.grouped_matmul.grouped_matmul import grouped_matmul_pallas
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as r_gmm_ref
from repro.models import layers as RL
from repro.models import moe as RM
from repro_torch.configs import get as tget
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bf16p_ref,
                                                     attention_ref)
from repro_torch.kernels.flash_decode import flash_decode as FD
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  flash_decode_split_ref)
from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
from repro_torch.kernels.grouped_matmul import ops as gmm
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

ARCH = "granite-moe-1b-a400m"
TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a, dtype):
    """The same values as a jax and a torch array of `dtype`."""
    j = jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))
    return j, torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


@pytest.fixture(autouse=True)
def no_launches():
    before = (dict(FA.LAUNCHES), FD.LAUNCHES["flash_decode"],
              dict(GM.LAUNCHES))
    yield
    assert (FA.LAUNCHES, FD.LAUNCHES["flash_decode"], GM.LAUNCHES) == before


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap,g", [
    (True, None, None, 1), (True, None, None, 2), (True, None, None, 4),
    (False, None, None, 2), (True, 48, None, 2), (True, None, 30.0, 2),
    (False, 64, 20.0, 4)])
def test_attention_matches_oracle_and_pallas(causal, window, softcap, g,
                                             dtype):
    rng = np.random.default_rng(g + 10 * causal + (window or 0))
    b, hkv, s, d = 1, 2, 256, 32
    qj, qt = _pair(rng.normal(size=(b, hkv * g, s, d)), dtype)
    kj, kt = _pair(rng.normal(size=(b, hkv, s, d)), dtype)
    vj, vt = _pair(rng.normal(size=(b, hkv, s, d)), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa_ops.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    torch.testing.assert_close(got, attention_ref(qt, kt, vt, **kw), rtol=0,
                               atol=0)
    _close(got, r_attention(qj, kj, vj, **kw), dtype)
    _close(got, flash_attention_pallas(qj, kj, vj, block_q=128, block_k=128,
                                       interpret=True, **kw), dtype)


@pytest.mark.parametrize("sq,skv,window", [(100, 100, None), (40, 100, None),
                                           (77, 77, 20)])
def test_attention_any_length_matches_oracle(sq, skv, window):
    rng = np.random.default_rng(sq + skv)
    qj, qt = _pair(rng.normal(size=(2, 4, sq, 16)), "float32")
    kj, kt = _pair(rng.normal(size=(2, 2, skv, 16)), "float32")
    vj, vt = _pair(rng.normal(size=(2, 2, skv, 16)), "float32")
    got = fa_ops.flash_attention(qt, kt, vt, window=window, scale=0.3)
    _close(got, r_attention(qj, kj, vj, window=window, scale=0.3), "float32")


@pytest.mark.parametrize("budget,n_chunks", [(1024, 6), (2047, 6),
                                              (4096, 2), (10 ** 9, 1)])
def test_attention_backward_in_chunks_equals_the_whole(budget, n_chunks,
                                                       monkeypatch):
    """The backward's recompute taken in chunks of rows and kv heads
    (at most `SCORE_BUDGET` scores each) gives the whole recompute's
    gradients, bit for bit: one kv head and row a chunk, two rows of
    every head, and one chunk."""
    monkeypatch.setattr(fa_ops, "SCORE_BUDGET", budget)
    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d = 3, 8, 2, 16, 8
    q, k, v = (torch.randn((b, h, s, d), generator=gen, requires_grad=True)
               for h in (hq, hkv, hkv))
    g = torch.randn((b, hq, s, d), generator=gen)
    assert len(fa_ops._chunks(b, hkv, (hq // hkv) * s * s)) == n_chunks
    want = torch.autograd.grad(attention_ref(q, k, v, window=5),
                               (q, k, v), g)
    got = torch.autograd.grad(fa_ops.flash_attention(q, k, v, window=5),
                              (q, k, v), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


# the bf16 kernel check chip_smoke.py applies: max|kernel - plain| <= this
# times max|plain| (LM_BF16_TOL there)
BF16_KERNEL_TOL = 8e-3


@pytest.mark.parametrize("g,sq,skv,causal,window,softcap", [
    (2, 256, 256, True, None, None),       # the LM prefill's class (G 2)
    (2, 256, 256, True, 48, None),         # window narrower than a kv tile
    (1, 256, 256, True, None, 30.0),
    (4, 256, 256, False, 64, 20.0),
    (2, 128, 256, True, None, None)])      # Sq != Skv
def test_bf16_rounding_model_within_kernel_tolerance(g, sq, skv, causal,
                                                     window, softcap):
    """The tensor-core kernel's roundings (`attention_bf16p_ref`: P rounded
    to bf16 before PV) stay within chip_smoke.py's bf16 check of the
    reference's oracle and its Pallas kernel (interpret mode), at the
    kernel's head_dim 64: the tolerance holds before the card sees it."""
    rng = np.random.default_rng(g + sq + (window or 0))
    b, hkv, d = 1, 2, 64
    qj, qt = _pair(rng.normal(size=(b, hkv * g, sq, d)), "bfloat16")
    kj, kt = _pair(rng.normal(size=(b, hkv, skv, d)), "bfloat16")
    vj, vt = _pair(rng.normal(size=(b, hkv, skv, d)), "bfloat16")
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = attention_bf16p_ref(qt, kt, vt, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    wants = [r_attention(qj, kj, vj, **kw)]
    if sq == skv:
        wants.append(flash_attention_pallas(qj, kj, vj, block_q=128,
                                            block_k=128, interpret=True, **kw))
    for want in wants:
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_KERNEL_TOL * np.abs(want).max(), err
    # the rounding of P shows: the model is not the f32-weight oracle
    assert not torch.equal(got, attention_ref(qt, kt, vt, **kw))


@pytest.mark.parametrize("dtype,hd,g,ptrs,kind", [
    ("bfloat16", 64, 2, (0, 0, 0), "wgmma"),    # the LM prefill
    ("bfloat16", 128, 1, (0, 0, 0), "wgmma"),
    ("bfloat16", 192, 4, (0, 0, 0), "wgmma"),
    ("bfloat16", 256, 16, (0, 0, 0), "wgmma"),
    ("float32", 64, 2, (0, 0, 0), "fma"),       # float32 stays exact
    ("bfloat16", 32, 2, (0, 0, 0), "fma"),      # below a 128-byte row
    ("bfloat16", 96, 2, (0, 0, 0), "fma"),      # not whole 128-byte rows
    ("bfloat16", 320, 2, (0, 0, 0), "fma"),     # above 256
    ("bfloat16", 64, 3, (0, 0, 0), "fma"),      # G not a power of two
    ("bfloat16", 64, 32, (0, 0, 0), "fma"),     # G above 16
    ("bfloat16", 64, 2, (0, 2, 0), "fma"),      # k 2 bytes off 16
    ("bfloat16", 64, 2, (8, 0, 0), "fma")])     # q 8 bytes off 16
def test_flash_attention_variant_is_chosen_by_dtype_shape_alignment(
        dtype, hd, g, ptrs, kind):
    assert FA.variant(getattr(torch, dtype), hd, g, ptrs) == kind


@pytest.mark.parametrize("entry", ["flash_attention_cuda",
                                   "flash_attention_wgmma",
                                   "flash_attention_fma"])
def test_flash_attention_cpu_tensors_take_the_plain_version(entry):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16) for shape in ((1, 4, 70, 64),
                                                 (1, 2, 70, 64),
                                                 (1, 2, 70, 64)))
    got = getattr(FA, entry)(q, k, v, window=20)
    torch.testing.assert_close(got, attention_ref(q, k, v, window=20),
                               rtol=0, atol=0)


# --------------------------------------------------------------------------
# flash decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,softcap", [(1, None), (2, None), (4, 30.0)])
def test_decode_matches_oracle_and_pallas(g, softcap, dtype):
    rng = np.random.default_rng(g)
    b, hkv, s, hd = 3, 2, 256, 32
    qj, qt = _pair(rng.normal(size=(b, hkv * g, hd)), dtype)
    kj, kt = _pair(rng.normal(size=(b, s, hkv, hd)), dtype)
    vj, vt = _pair(rng.normal(size=(b, s, hkv, hd)), dtype)
    lengths = np.array([0, s, 77], np.int32)          # empty, full, ragged
    got = fd_ops.flash_decode(qt, kt, vt, torch.from_numpy(lengths),
                              softcap=softcap)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = r_decode(qj, kj, vj, jnp.asarray(lengths), softcap=softcap)
    kernel = np.asarray(flash_decode_pallas(
        qj, kj, vj, jnp.asarray(lengths), softcap=softcap, block_s=128,
        interpret=True), np.float32)
    _close(got, kernel, dtype)
    # at length 0 the port (plain and CUDA) writes zeros, as the Pallas
    # kernel does; the reference's oracle averages every slot there
    np.testing.assert_array_equal(kernel[0], 0.0)
    np.testing.assert_array_equal(got[0].float().numpy(), 0.0)
    _close(got[1:], np.asarray(want, np.float32)[1:], dtype)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1024, 4096])
def test_plan_splits_stays_in_its_bounds(s):
    """The split count comes from shapes and the SM count only: a power of
    two, never above 8 or ceil(S / 64), the smallest that gives 2 x n_sm
    CTAs where the cap allows; the main path (B 8 x Hkv 8, S 1024) gets 8."""
    n_sm, cap = 132, min(8, -(-s // 64))
    for bh in range(1, 257):
        n = FD.plan_splits(bh, s, n_sm)
        assert 1 <= n <= cap and n & (n - 1) == 0
        assert bh * n >= 2 * n_sm or 2 * n > cap
        assert n == 1 or bh * (n // 2) < 2 * n_sm
    if s == 1024:
        assert FD.plan_splits(64, s, n_sm) == 8


def _bf16_cache(shape, offset=0):
    """A zero bf16 cache of `shape` starting `offset` elements into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("hd,g,dtype,offset,want", [
    (64, 2, torch.bfloat16, 0, (16, 1, 8, 2)),     # the main path
    (36, 2, torch.bfloat16, 0, (8, 1, 16, 2)),     # 72-byte rows
    (64, 2, torch.bfloat16, 1, (2, 2, 32, 2)),     # cache 2 bytes off
    (64, 2, torch.bfloat16, 4, (8, 1, 16, 2)),     # cache 8 bytes off
    (256, 1, torch.float32, 0, (16, 2, 32, 1)),
    (128, 4, torch.float32, 0, (16, 1, 32, 4)),
    (8, 8, torch.bfloat16, 0, (16, 1, 1, 4))])     # two head groups
def test_plan_launch_picks_widths_from_shapes_and_alignment(hd, g, dtype,
                                                            offset, want):
    b, hkv, s = 8, 8, 1024
    q = torch.zeros((b, hkv * g, hd), dtype=dtype)
    if dtype == torch.bfloat16:
        k = _bf16_cache((b, s, hkv, hd), offset)
    else:
        k = torch.zeros((b, s, hkv, hd), dtype=dtype)
    plan = FD.plan_launch(q, k, k, n_sm=132)
    assert (plan.vec, plan.nv, plan.gs, plan.gt) == want
    n_hg = -(-g // plan.gt)
    assert plan.grid == (b * hkv * n_hg, plan.n_split)
    assert plan.n_split == FD.plan_splits(b * hkv * n_hg, s, 132)
    assert plan.cluster == (plan.n_split > 1)
    assert plan.gs * plan.nv * plan.vec >= hd * k.element_size()
    assert plan.smem == FD.smem_bytes(plan.gs, plan.gt, hd,
                                 plan.n_split) <= FD.SMEM_BYTES
    if (hd, g, offset) == (64, 2, 0):
        assert plan.n_split == 8 and plan.ctas == 512
    forced = FD.plan_launch(q, k, k, n_sm=132, n_split=3)
    assert forced.grid == (plan.grid[0], 3) and forced.cluster
    with pytest.raises(ValueError, match="n_split"):
        FD.plan_launch(q, k, k, n_sm=132, n_split=9)


def test_plan_launch_raises_for_rows_it_cannot_hold():
    q = torch.zeros((1, 1, 4096), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, 4096), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 4096"):
        FD.plan_launch(q, k, k, n_sm=132)


@pytest.fixture(scope="module")
def split_case():
    """Decode operands with lengths 0, 1, 77 and S, and the reference's
    oracle and Pallas kernel (interpret mode) on them."""
    rng = np.random.default_rng(5)
    b, hkv, g, s, hd = 4, 2, 2, 256, 32
    qj, qt = _pair(rng.normal(size=(b, hkv * g, hd)), "float32")
    kj, kt = _pair(rng.normal(size=(b, s, hkv, hd)), "float32")
    vj, vt = _pair(rng.normal(size=(b, s, hkv, hd)), "float32")
    lengths = np.array([0, 1, 77, s], np.int32)
    oracle = np.asarray(r_decode(qj, kj, vj, jnp.asarray(lengths),
                                 softcap=30.0), np.float32)
    pallas = np.asarray(flash_decode_pallas(
        qj, kj, vj, jnp.asarray(lengths), softcap=30.0, block_s=128,
        interpret=True), np.float32)
    return (qt, kt, vt, torch.from_numpy(lengths)), oracle, pallas


@pytest.mark.parametrize("n_split", range(1, 9))
def test_split_plain_version_matches_oracle_and_pallas(split_case, n_split):
    """The kernel's chunk rule and log-sum-exp merge, in plain PyTorch, at
    every split count: length 1 leaves every chunk but the first empty,
    length 0 every chunk (zeros, as the Pallas kernel writes; the oracle
    averages every slot there)."""
    (q, k, v, lengths), oracle, pallas = split_case
    # caches 0, 4 and 8 bytes into their storage: the launch plan takes
    # 16-, 4- and 8-byte loads, so chunks round up to 4, 1 and 2 positions
    for offset, align in ((0, 4), (1, 1), (2, 2)):
        ko, vo = (torch.cat([t.new_zeros(offset), t.flatten()])[offset:]
                  .view(t.shape) for t in (k, v))
        assert 32 // FD.plan_launch(q, ko, vo, 0, n_split).gs == align
        got = flash_decode_split_ref(q, ko, vo, lengths, n_split,
                                     softcap=30.0)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert bool(torch.isfinite(got).all())
        _close(got, pallas, "float32")
        _close(got[1:], oracle[1:], "float32")
        np.testing.assert_array_equal(got[0].numpy(), 0.0)


@pytest.mark.parametrize("s_cache,window,positions", [
    (16, None, [3, 15]),       # full attention: a prefix of pos + 1 slots
    (8, 8, [5, 19]),           # ring buffer, the second one wrapped
    (16, 4, [2, 9]),           # window inside a longer cache: no prefix
    (64, 16, [5, 40]),         # the same, the second one past the window
    (16, None, [16, 21])])     # past the cache: the write clamps to slot 15
def test_decode_attention_matches_reference_masked_path(s_cache, window,
                                                        positions):
    """attention_apply's decode mode (flash_decode with lengths =
    min(pos + 1, s_cache), or the masked path where the valid slots are no
    prefix) against the reference's masked `_decode_attention`."""
    rng = np.random.default_rng(s_cache + (window or 0))
    rcfg = RC.get(ARCH, reduced=True)
    tcfg = tget(ARCH, reduced=True)
    d, hkv, hd = rcfg.d_model, rcfg.n_kv_heads, rcfg.resolved_head_dim
    h = rcfg.n_heads
    params = {n: {"w": rng.normal(size=shape) / np.sqrt(shape[0])}
              for n, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                               ("wv", (d, hkv * hd)), ("wo", (h * hd, d)))}
    x = rng.normal(size=(2, 1, d))
    k = rng.normal(size=(2, s_cache, hkv, hd))
    v = rng.normal(size=(2, s_cache, hkv, hd))
    pos = np.array(positions, np.int32)
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    want, wcache = jax.jit(lambda *a: RL.attention_apply(
        a[0], rcfg, a[1], a[2], layer_window=window, mode="decode",
        cache=RL.KVCache(a[3], a[4]), cache_pos=a[5]))(
        rp, jnp.asarray(x, jnp.float32), jnp.asarray(pos[:, None]),
        jnp.asarray(k, jnp.float32), jnp.asarray(v, jnp.float32),
        jnp.asarray(pos))
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a, dtype=torch.float32),
                                params)
    cache = TL.KVCache(torch.tensor(k, dtype=torch.float32),
                       torch.tensor(v, dtype=torch.float32))
    got, gcache = TL.attention_apply(
        tp, tcfg, torch.tensor(x, dtype=torch.float32),
        torch.from_numpy(pos[:, None]).long(), layer_window=window,
        mode="decode", cache=cache, cache_pos=torch.from_numpy(pos).long())
    assert gcache is cache                   # written in place
    _close(got, want, "float32")
    _close(gcache.k, wcache.k, "float32")
    _close(gcache.v, wcache.v, "float32")


# --------------------------------------------------------------------------
# grouped matmul and the sorted dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row_tile,eids,cin,cout", [
    (8, [2, 0, 0, 3, 1, 2], 24, 40),        # unequal segments, revisits
    (128, [1, 1, 0], 64, 48)])
def test_grouped_matmul_matches_pallas(row_tile, eids, cin, cout, dtype):
    rng = np.random.default_rng(row_tile + cin)
    rows = row_tile * len(eids)
    xj, xt = _pair(rng.normal(size=(rows, cin)), dtype)
    wj, wt = _pair(rng.normal(size=(4, cin, cout)) / np.sqrt(cin), dtype)
    eid = np.array(eids, np.int32)
    got = gmm.grouped_matmul(xt, torch.from_numpy(eid), wt, row_tile)
    assert got.dtype == xt.dtype and got.shape == (rows, cout)
    torch.testing.assert_close(
        got, grouped_matmul_ref(xt, torch.from_numpy(eid), wt, row_tile),
        rtol=0, atol=0)
    _close(got, grouped_matmul_pallas(xj, jnp.asarray(eid), wj,
                                      row_tile=row_tile, interpret=True),
           dtype)


def test_grouped_matmul_out_of_range_ids_follow_reference():
    """Ids out of range take the reference's rule (jnp indexing: a negative
    id wraps once, then clamps): with E = 8, ids (9, -3, -10) take experts
    (7, 5, 0), in the oracle and in the Pallas kernel; the CUDA kernels
    apply the same rule (`expert_id`, held on the card)."""
    rng = np.random.default_rng(8)
    row_tile, cin, cout, e = 8, 16, 24, 8
    eids = np.array([9, -3, -10], np.int32)
    xj, xt = _pair(rng.normal(size=(row_tile * len(eids), cin)), "float32")
    wj, wt = _pair(rng.normal(size=(e, cin, cout)), "float32")
    got = gmm.grouped_matmul(xt, torch.from_numpy(eids), wt, row_tile)
    _close(got, r_gmm_ref(xj, jnp.asarray(eids), wj, row_tile), "float32")
    n = 2 * row_tile            # ids 9 and -3 through the Pallas kernel
    _close(got[:n], grouped_matmul_pallas(
        xj[:n], jnp.asarray(eids[:2]), wj, row_tile=row_tile,
        interpret=True), "float32")


_LM = tget(ARCH)


@pytest.mark.parametrize("dtype,cin,cout,row_tile,kind", [
    ("bfloat16", _LM.d_model, _LM.d_ff, 128, "wgmma"),   # w_in, w_gate
    ("bfloat16", _LM.d_ff, _LM.d_model, 128, "wgmma"),   # w_out
    ("bfloat16", 200, 136, 256, "wgmma"),                # tails, 2 CTAs a tile
    ("float32", _LM.d_model, _LM.d_ff, 128, "fma"),      # no TF32
    ("float32", _LM.d_ff, _LM.d_model, 128, "fma"),
    ("bfloat16", 200, 300, 128, "fma"),                  # Cout not of 8
    ("bfloat16", 204, 512, 128, "fma"),                  # Cin not of 8
    ("bfloat16", 1024, 512, 64, "fma")])                 # half a wgmma CTA
def test_grouped_matmul_variant_is_chosen_by_dtype_and_shape(
        dtype, cin, cout, row_tile, kind):
    assert GM.variant(getattr(torch, dtype), cin, cout, row_tile) == kind


@pytest.mark.parametrize("entry", ["grouped_matmul_cuda",
                                   "grouped_matmul_wgmma",
                                   "grouped_matmul_fma"])
def test_grouped_matmul_cpu_tensors_take_the_plain_version(entry):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 24)).astype(np.float32))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    eid = torch.tensor([2, 0], dtype=torch.int32)
    got = getattr(GM, entry)(x, eid, w, 128)
    torch.testing.assert_close(got, grouped_matmul_ref(x, eid, w, 128),
                               rtol=0, atol=0)


@pytest.mark.parametrize("t,topk,e,capacity,skew", [
    (50, 3, 5, 40, False),      # no drops
    (50, 3, 5, 16, False),      # capacity drops
    (64, 2, 8, 8, True)])       # most assignments on one expert
def test_make_dispatch_integers_equal(t, topk, e, capacity, skew):
    rng = np.random.default_rng(t + capacity)
    if skew:
        idx = np.where(rng.random((t, topk)) < 0.7, 3,
                       rng.integers(0, e, (t, topk)))
    else:
        idx = rng.integers(0, e, (t, topk))
    idx = idx.astype(np.int32)
    want = r_gmm.make_dispatch(jnp.asarray(idx), e, capacity, row_tile=8)
    got = gmm.make_dispatch(torch.from_numpy(idx), e, capacity, row_tile=8)
    assert got.n_rows == want.n_rows
    for name in ("dest_row", "tile_eid", "src_token"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert (got.dest_row < 0).any() == (capacity < 40 or skew)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_sorted_moe_ffn_matches_reference(use_kernel, dtype):
    rng = np.random.default_rng(7)
    t, d, f, e, topk = 40, 16, 24, 4, 2
    xj, xt = _pair(rng.normal(size=(t, d)), dtype)
    w_in = rng.normal(size=(e, d, f)) / 4
    w_gate = rng.normal(size=(e, d, f)) / 4
    w_out = rng.normal(size=(e, f, d)) / 5
    idx = np.stack([rng.permutation(e)[:topk] for _ in range(t)]).astype(
        np.int32)
    gates = rng.random((t, topk))
    gates /= gates.sum(-1, keepdims=True)
    jw = [_pair(w, dtype) for w in (w_in, w_gate, w_out, gates)]
    want = jax.jit(lambda *a: r_gmm.sorted_moe_ffn(
        *a[:5], w_gate=a[5], row_tile=8, use_kernel=use_kernel,
        interpret=True))(xj, jnp.asarray(idx), jw[3][0], jw[0][0], jw[2][0],
                         jw[1][0])
    got = gmm.sorted_moe_ffn(xt, torch.from_numpy(idx), jw[3][1], jw[0][1],
                             jw[2][1], w_gate=jw[1][1], row_tile=8)
    assert got.dtype == xt.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("router", ["zero", "paired"])
def test_route_breaks_ties_like_lax_top_k(router):
    """Tied probabilities rank lowest expert first in both."""
    rng = np.random.default_rng(3)
    rcfg = RC.get(ARCH, reduced=True)          # 8 experts, top 4
    tcfg = tget(ARCH, reduced=True)
    d, e = rcfg.d_model, rcfg.n_experts
    if router == "zero":
        w = np.zeros((d, e))
    else:                                      # experts 2i and 2i + 1 tie
        w = np.repeat(rng.normal(size=(d, e // 2)), 2, axis=1)
    x = rng.normal(size=(20, d))
    gj, ij, aj = RM.route({"router": {"w": jnp.asarray(w, jnp.float32)}},
                          rcfg, jnp.asarray(x, jnp.float32))
    gt, it, at = TM.route({"router": {"w": torch.tensor(w,
                                                        dtype=torch.float32)}},
                          tcfg, torch.tensor(x, dtype=torch.float32))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(gt, gj, "float32")
    _close(at, aj, "float32")
    if router == "zero":
        np.testing.assert_array_equal(it.numpy(), np.tile(np.arange(4),
                                                          (20, 1)))
