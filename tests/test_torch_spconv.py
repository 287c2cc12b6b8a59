"""Port parity, floats: the sparse-conv plain versions, the epilogue and
the conv flows, against the reference's oracles and its Pallas kernel run
in interpret mode; plus the kernel wrappers' CPU policy.  The kernels
themselves are checked on a card by tests/test_torch_gpu.py.

Tolerance: atol = rtol = 1e-4, the reference's own `TOL`
(tests/test_spconv_fused.py): float32 sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as M
from repro.core import sparseconv as SC
from repro.kernels.spconv import ops as spops
from repro.kernels.spconv.ref import spconv_fod_fused_ref, spconv_fod_ref
from repro.kernels.spconv.spconv import spconv_fod_fused_pallas
from repro_torch.core import mapping as TM
from repro_torch.core import sparseconv as TSC
from repro_torch.kernels.spconv import ref as tref
from repro_torch.kernels.spconv import spconv as TK
from tests.test_mapping import random_cloud

TOL = dict(rtol=1e-4, atol=1e-4)


def problem(seed, n=150, m=100, cin=5, cout=7, k=27):
    """Odd Cin/Cout, random -1 entries, the full epilogue."""
    rng = np.random.default_rng(seed)
    p = {"feats": rng.normal(size=(n, cin)).astype(np.float32),
         "w": (rng.normal(size=(k, cin, cout)) * 0.2).astype(np.float32),
         "inv": rng.integers(-1, n, size=(k, m)).astype(np.int32),
         "bias": rng.normal(size=cout).astype(np.float32),
         "ln_s": rng.normal(size=cout).astype(np.float32),
         "ln_b": rng.normal(size=cout).astype(np.float32),
         "res": rng.normal(size=(m, cout)).astype(np.float32),
         "mask": (rng.random(m) > 0.3).astype(np.float32)}
    p["inv"][rng.random((k, m)) < 0.4] = -1
    p["inv"][3] = -1                          # one all-empty offset
    return p


def epilogues(p, lib, arr):
    return lib.Epilogue(bias=arr(p["bias"]), ln_scale=arr(p["ln_s"]),
                        ln_bias=arr(p["ln_b"]), relu=True,
                        mask=arr(p["mask"]), residual=arr(p["res"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_spconv_matches_reference_oracle_and_pallas(seed):
    p = problem(seed)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    j = {k: jnp.asarray(v) for k, v in p.items()}
    got = tref.spconv_fod_ref(t["feats"], t["inv"], t["w"]).numpy()
    np.testing.assert_allclose(
        got, np.asarray(spconv_fod_ref(j["feats"], j["inv"], j["w"])), **TOL)
    epi_t = epilogues(p, TSC, torch.from_numpy)
    epi_j = epilogues(p, SC, jnp.asarray)
    got = tref.spconv_fod_fused_ref(t["feats"], t["inv"], t["w"],
                                    epi_t).numpy()
    np.testing.assert_allclose(
        got, np.asarray(spconv_fod_fused_ref(j["feats"], j["inv"], j["w"],
                                             epi_j)), **TOL)
    # the reference's fused Pallas kernel, interpret mode, on the padded
    # problem its wrapper would build (rows to the tile grid)
    out_tile, feat_tile = 64, 64
    m, n = p["inv"].shape[1], p["feats"].shape[0]
    m_pad, n_pad = 128, 192
    inv = jnp.pad(j["inv"], ((0, 0), (0, m_pad - m)), constant_values=-1)
    feats = jnp.pad(j["feats"], ((0, n_pad - n), (0, 0)))
    wmap, nwin = spops.window_schedule(inv, n_pad, out_tile, feat_tile)
    pal = spconv_fod_fused_pallas(
        feats, inv, j["w"], wmap, nwin, bias=j["bias"], ln_scale=j["ln_s"],
        ln_bias=j["ln_b"], residual=jnp.pad(j["res"], ((0, m_pad - m), (0, 0))),
        mask=jnp.pad(j["mask"], (0, m_pad - m)), relu=True,
        feat_tile=feat_tile, out_tile=out_tile, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal)[:m], **TOL)
    # the kernel wrappers on CPU tensors: the plain version, no launch
    TK.reset_launch_counts()
    np.testing.assert_array_equal(
        TK.spconv_fod_fused_cuda(t["feats"], t["inv"], t["w"], epi_t).numpy(),
        got)
    TK.spconv_fod_cuda(t["feats"], t["inv"], t["w"])
    assert not any(TK.LAUNCHES.values())


@pytest.mark.parametrize("fields", ["all", "ln_only", "no_ln"])
def test_apply_epilogue_matches_reference(fields):
    p = problem(3, cout=9)
    rng = np.random.default_rng(4)
    acc = rng.normal(size=(100, 9)).astype(np.float32) * 3
    epi_t = epilogues(p, TSC, torch.from_numpy)
    epi_j = epilogues(p, SC, jnp.asarray)
    if fields == "ln_only":
        epi_t, epi_j = (e._replace(bias=None, residual=None, mask=None,
                                   relu=False) for e in (epi_t, epi_j))
    elif fields == "no_ln":
        epi_t, epi_j = (e._replace(ln_scale=None, ln_bias=None)
                        for e in (epi_t, epi_j))
    np.testing.assert_allclose(
        TSC.apply_epilogue(torch.from_numpy(acc), epi_t).numpy(),
        np.asarray(SC.apply_epilogue(jnp.asarray(acc), epi_j)), **TOL)
    with pytest.raises(ValueError, match="together"):
        TSC.apply_epilogue(torch.from_numpy(acc),
                           TSC.Epilogue(ln_scale=torch.ones(9)))


@pytest.mark.parametrize("transposed", [False, True])
def test_conv_flows_match_reference_flows(transposed):
    """gms / fod / cuda / cuda_fused (plain versions on CPU) against the
    reference's gms and fod on real v2 maps, strided and swapped."""
    rng = np.random.default_rng(9)
    coords, mask = random_cloud(rng, 70, 96, grid=8)
    ref_pc = M.make_point_cloud(jnp.asarray(coords), jnp.asarray(mask))
    port_pc = TM.make_point_cloud(torch.from_numpy(coords),
                                  torch.from_numpy(mask))
    rmaps, rout = M.build_conv_maps(ref_pc, 2, 2)
    tmaps, tout = TM.build_conv_maps(port_pc, 2, 2)
    cin, cout = 6, 5
    n_in = rout.capacity if transposed else 96
    feats = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(8, cin, cout)) * 0.3).astype(np.float32)
    if transposed:
        want = SC.sparse_conv_transposed(jnp.asarray(feats), rmaps, ref_pc,
                                         jnp.asarray(w), flow="fod")
    else:
        want = SC.sparse_conv_apply(jnp.asarray(feats), rmaps, jnp.asarray(w),
                                    rout.capacity, flow="gms")
    for flow in TSC.FLOWS:
        if transposed:
            got = TSC.sparse_conv_transposed(
                torch.from_numpy(feats), tmaps, port_pc, torch.from_numpy(w),
                flow=flow)
        else:
            got = TSC.sparse_conv_apply(torch.from_numpy(feats), tmaps,
                                        torch.from_numpy(w), tout.capacity,
                                        flow=flow)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=flow)
    with pytest.raises(ValueError, match="unknown flow"):
        TSC.sparse_conv_apply(torch.from_numpy(feats), tmaps,
                              torch.from_numpy(w), tout.capacity,
                              flow="pallas")


def test_wrappers_check_operands():
    p = problem(5)
    f, inv, w = (torch.from_numpy(p[k]) for k in ("feats", "inv", "w"))
    with pytest.raises(TypeError, match="int32"):
        TK.spconv_fod_cuda(f, inv.long(), w)
    with pytest.raises(ValueError, match="do not match"):
        TK.spconv_fod_cuda(f, inv, w[:, :3])
    with pytest.raises(TypeError, match="float32"):
        TK.spconv_fod_fused_cuda(f.double(), inv, w)
