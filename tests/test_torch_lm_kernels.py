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
from repro.models import layers as RL
from repro.models import moe as RM
from repro_torch.configs import get as tget
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import flash_decode as FD
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
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
    before = (FA.LAUNCHES["flash_attention"], FD.LAUNCHES["flash_decode"],
              dict(GM.LAUNCHES))
    yield
    assert (FA.LAUNCHES["flash_attention"], FD.LAUNCHES["flash_decode"],
            GM.LAUNCHES) == before


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


@pytest.mark.parametrize("s_cache,window,positions", [
    (16, None, [3, 15]),       # full attention: a prefix of pos + 1 slots
    (8, 8, [5, 19]),           # ring buffer, the second one wrapped
    (16, 4, [2, 9])])          # window inside a longer cache: no prefix
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
