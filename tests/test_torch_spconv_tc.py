"""The tensor-core sparse conv's plan and arithmetic, on the CPU.

`plan_conv` is a pure function of shapes, alignment and the SM count;
`spconv_fod_tf32x3_ref` repeats the kernel's split-float TF32 arithmetic
(csrc/spconv_tc.cu) in plain torch and is held against the reference's
oracle (under jax.jit) and its fused Pallas kernel (interpret mode).  The
kernel itself is checked on a card by tests/test_torch_gpu.py.

Tolerance: atol = rtol = 1e-4, the reference's own `TOL`
(tests/test_spconv_fused.py) and chip_smoke.py's site check.  The
one-product (hi*hi) scheme must miss it at the 256 width: the check can
tell the schemes apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparseconv as SC
from repro.kernels.spconv import ops as spops
from repro.kernels.spconv.ref import spconv_fod_fused_ref, spconv_fod_ref
from repro.kernels.spconv.spconv import spconv_fod_fused_pallas
from repro_torch.core import sparseconv as TSC
from repro_torch.kernels.spconv import ref as tref
from repro_torch.kernels.spconv import spconv as TK

TOL = dict(rtol=1e-4, atol=1e-4)
N_SM = 132                                 # the H100 SXM's SMs
# MinkUNet's main-path conv shapes (m, Cin, Cout, K) at each stride level of
# a 50k-point scene (level-0..4 rows 50000 / 26138 / 8087 / 2063 / 534)
LEVELS = {0: (50000, 32, 32, 27), 1: (26138, 32, 32, 27),
          2: (8087, 64, 64, 27), 3: (2063, 256, 256, 27),
          4: (534, 256, 256, 27)}


def problem(seed, n, m, cin, cout, k=27):
    rng = np.random.default_rng(seed)
    p = {"feats": rng.normal(size=(n, cin)).astype(np.float32),
         "w": (rng.normal(size=(k, cin, cout)) * 0.2).astype(np.float32),
         "inv": rng.integers(-1, n, size=(k, m)).astype(np.int32),
         "ln_s": rng.normal(size=cout).astype(np.float32),
         "ln_b": rng.normal(size=cout).astype(np.float32),
         "res": rng.normal(size=(m, cout)).astype(np.float32),
         "mask": (rng.random(m) > 0.3).astype(np.float32)}
    p["inv"][rng.random((k, m)) < 0.4] = -1
    p["inv"][3] = -1                          # one all-empty offset
    return p


def minkunet_epilogue(p, lib, arr):
    """A trunk conv's epilogue: layernorm -> +skip -> ReLU -> row mask."""
    return lib.Epilogue(ln_scale=arr(p["ln_s"]), ln_bias=arr(p["ln_b"]),
                        relu=True, mask=arr(p["mask"]),
                        residual=arr(p["res"]))


@jax.jit
def _oracle(feats, inv, w):
    return spconv_fod_ref(feats, inv, w)


@jax.jit
def _fused_oracle(feats, inv, w, ln_s, ln_b, res, mask):
    epi = SC.Epilogue(ln_scale=ln_s, ln_bias=ln_b, relu=True, mask=mask,
                      residual=res)
    return spconv_fod_fused_ref(feats, inv, w, epi)


def test_plan_is_a_function_of_shapes_only():
    p = problem(0, 400, 300, 32, 64)
    f, w = torch.from_numpy(p["feats"]), torch.from_numpy(p["w"])
    inv_a = torch.from_numpy(p["inv"])
    inv_b = torch.full_like(inv_a, -1)
    inv_b[:, :7] = 5
    for fused in (False, True):
        for n_split in (None, 3, 8):
            plans = {TK.plan_for(f, inv, w, fused=fused, n_split=n_split,
                                 n_sm=N_SM) for inv in (inv_a, inv_b)}
            assert plans == {TK.plan_conv(300, 32, 64, 27, N_SM, n_split,
                                          fused, True)}
            assert plans.pop().n_split == (n_split or 4)   # Cout 64


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("padded", [False, True])
def test_plan_fills_the_card_at_every_level(level, padded):
    """The main path pads every level to the bucket (M = 65536), so the
    plan cannot see a level's live tiles: it launches two waves of two CTAs
    an SM as clusters (8 CTAs for 256-column tiles, 4 for narrower) that
    can spread one tile over all their ranks."""
    m, cin, cout, k = LEVELS[level]
    m = 65536 if padded else m
    plan = TK.plan_conv(m, cin, cout, k, N_SM)
    tiles = -(-m // TK.ROWS_PER_CTA)
    n = 8 if cout > 128 else 4
    assert plan.variant == "tc" and plan.n_split == n
    assert plan.clusters == min(tiles, TK.WAVES * TK.CTAS_PER_SM * N_SM // n)
    assert plan.grid == (plan.clusters * n, 1)
    assert -(-tiles // plan.clusters) <= TK.MAX_CLUSTER_TILES
    assert plan.ctas >= min(N_SM, n * tiles)


@pytest.mark.parametrize("level,live_tiles,busy", [(3, 33, 264), (4, 9, 72),
                                                   (0, 782, 528)])
def test_device_rule_spreads_few_live_tiles_over_the_clusters(
        level, live_tiles, busy):
    """Live tiles lead the padded level; cluster c owns tiles c, c + G, ...
    Its first round gives every rank work while it holds a live tile:
    MinkUNet's level 3 (33 live tiles) keeps 264 CTAs busy, level 4 (9)
    72, level 0 (782) all 528 (two waves)."""
    _, cin, cout, k = LEVELS[level]
    plan = TK.plan_conv(65536, cin, cout, k, N_SM)
    held = [len(range(c, live_tiles, plan.clusters))
            for c in range(plan.clusters)]
    first_round = sum(sum(s for _, s in TK.round_groups(n, plan.n_split))
                      for n in held if n)
    assert first_round == busy


@pytest.mark.parametrize("n_split", range(1, 9))
def test_round_groups_partition_the_cluster(n_split):
    for left in range(1, 20):
        groups = TK.round_groups(left, n_split)
        assert len(groups) == min(n_split, left)
        assert [f for f, _ in groups] == sorted(f for f, _ in groups)
        ranks = [r for f, s in groups for r in range(f, f + s)]
        assert ranks == list(range(n_split))
        sizes = {s for _, s in groups}
        assert max(sizes) - min(sizes) <= 1
        g = len(groups)
        for j, (f, s) in enumerate(groups):   # the kernel's rank -> group
            assert all(r * g // n_split == j for r in range(f, f + s))


@pytest.mark.parametrize("m", [1, 64, 65, 534, 2063, 8087, 65536])
@pytest.mark.parametrize("k", [1, 3, 8, 27])
@pytest.mark.parametrize("cout", [32, 96, 300])
def test_plan_split_is_a_power_of_two_up_to_eight(m, k, cout):
    plan = TK.plan_conv(m, 64, cout, k, N_SM, fused=False)
    tiles = -(-m // TK.ROWS_PER_CTA)
    cap = 8 if cout > 128 else 4
    assert plan.n_split in (1, 2, 4, 8) and plan.n_split <= min(cap, k)
    assert 2 * plan.n_split > min(cap, k)   # the largest such
    assert plan.grid == (plan.clusters * plan.n_split,
                         -(-cout // plan.cn))
    assert 1 <= plan.clusters <= tiles


@pytest.mark.parametrize("cin,cout,fused,aligned,want", [
    (4, 32, True, True, "tc"),                # the stem
    (384, 256, True, True, "tc"),             # the widest decoder concat
    (128, 96, True, True, "tc"),              # Cout 96: no power of two
    (300, 300, False, True, "tc"),            # two Cout tiles, unfused
    (300, 300, True, True, "fma"),            # fused: Cout > 256
    (5, 32, True, True, "fma"),               # odd Cin
    (32, 7, False, True, "fma"),              # odd Cout
    (6, 32, True, True, "fma"),               # Cin not a multiple of 4
    (32, 64, True, False, "fma")])            # operands not 16-byte aligned
def test_variant_rule(cin, cout, fused, aligned, want):
    assert TK.variant(cin, cout, 27, fused, aligned) == want
    plan = TK.plan_conv(500, cin, cout, 27, N_SM, None, fused, aligned)
    assert plan.variant == want
    if want == "fma":
        assert plan.n_split == 1
        assert plan.clusters == plan.grid[0] == 8    # one CTA a row tile
        with pytest.raises(ValueError, match="does not split"):
            TK.plan_conv(500, cin, cout, 27, N_SM, 2, fused, aligned)


@pytest.mark.parametrize("k,want", [(27, "tc"), (TK.MAX_KVOL, "tc"),
                                    (TK.MAX_KVOL + 1, "fma")])
def test_variant_takes_at_most_max_kvol_offsets(k, want):
    """The kernel's shared memory holds 64 indices an offset: it sizes
    itself and fits MAX_KVOL offsets at every column tile."""
    for cout in (32, 64, 128, 256):
        assert TK.variant(64, cout, k, True) == want


def test_unaligned_operand_plans_the_fma_kernel():
    p = problem(1, 40, 30, 8, 16)
    f = torch.from_numpy(p["feats"])
    shifted = torch.empty(f.numel() + 1)[1:].view(f.shape)
    shifted.copy_(f)
    w, inv = torch.from_numpy(p["w"]), torch.from_numpy(p["inv"])
    assert TK.plan_for(f, inv, w, fused=True, n_sm=N_SM).variant == "tc"
    assert TK.plan_for(shifted, inv, w, fused=True,
                       n_sm=N_SM).variant == "fma"


@pytest.mark.parametrize("n_split", [0, 9])
def test_forced_split_out_of_range_raises(n_split):
    with pytest.raises(ValueError, match="n_split"):
        TK.plan_conv(500, 32, 32, 27, N_SM, n_split)


def test_tf32_rounds_to_nearest_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                          # TF32's step at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 3.0, 0.0])
    torch.testing.assert_close(tref.tf32_rna(x), want, rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(2).normal(size=1000)
                         .astype(np.float32))
    hi = tref.tf32_rna(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("n_split", [1, 4, 8])
@pytest.mark.parametrize("with_epilogue", [False, True])
def test_tf32x3_emulation_matches_reference_oracle(n_split, with_epilogue):
    """Cin = Cout = 256, K = 27, a few hundred rows: the level-3/4 width."""
    p = problem(3, 400, 300, 256, 256)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    j = {k: jnp.asarray(v) for k, v in p.items()}
    if with_epilogue:
        got = tref.spconv_fod_fused_tf32x3_ref(
            t["feats"], t["inv"], t["w"],
            minkunet_epilogue(p, TSC, torch.from_numpy), n_split)
        want = _fused_oracle(j["feats"], j["inv"], j["w"], j["ln_s"],
                             j["ln_b"], j["res"], j["mask"])
    else:
        got = tref.spconv_fod_tf32x3_ref(t["feats"], t["inv"], t["w"],
                                         n_split)
        want = _oracle(j["feats"], j["inv"], j["w"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_one_product_emulation_misses_the_tolerance():
    """Negative control: hi*hi alone (plain TF32) fails the check that the
    three-product scheme passes, on the unfused sum at the 256 width."""
    p = problem(3, 400, 300, 256, 256)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(_oracle(*(jnp.asarray(p[k])
                                for k in ("feats", "inv", "w"))))
    got = tref.spconv_fod_tf32x3_ref(t["feats"], t["inv"], t["w"],
                                     products=1).numpy()
    assert not np.allclose(got, want, **TOL)
    excess = np.abs(got - want) - (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert float(excess.max()) > 1e-3


def test_tf32x3_emulation_matches_pallas_interpret():
    """A small width against the reference's fused Pallas kernel."""
    p = problem(4, 150, 100, 8, 16)
    p["bias"] = np.random.default_rng(5).normal(size=16).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    j = {k: jnp.asarray(v) for k, v in p.items()}
    epi_t = minkunet_epilogue(p, TSC, torch.from_numpy)._replace(
        bias=t["bias"])
    got = tref.spconv_fod_fused_tf32x3_ref(t["feats"], t["inv"], t["w"],
                                           epi_t, n_split=2).numpy()
    out_tile, feat_tile, m_pad, n_pad = 64, 64, 128, 192
    inv = jnp.pad(j["inv"], ((0, 0), (0, m_pad - 100)), constant_values=-1)
    feats = jnp.pad(j["feats"], ((0, n_pad - 150), (0, 0)))
    wmap, nwin = spops.window_schedule(inv, n_pad, out_tile, feat_tile)
    pal = spconv_fod_fused_pallas(
        feats, inv, j["w"], wmap, nwin, bias=j["bias"], ln_scale=j["ln_s"],
        ln_bias=j["ln_b"], residual=jnp.pad(j["res"], ((0, m_pad - 100),
                                                       (0, 0))),
        mask=jnp.pad(j["mask"], (0, m_pad - 100)), relu=True,
        feat_tile=feat_tile, out_tile=out_tile, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal)[:100], **TOL)


def test_cpu_wrappers_take_the_plain_version_with_a_split():
    p = problem(6, 150, 100, 8, 16)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    TK.reset_launch_counts()
    got = TK.spconv_fod_cuda(t["feats"], t["inv"], t["w"], n_split=4)
    torch.testing.assert_close(
        got, tref.spconv_fod_ref(t["feats"], t["inv"], t["w"]), rtol=0,
        atol=0)
    epi = minkunet_epilogue(p, TSC, torch.from_numpy)
    got = TK.spconv_fod_fused_cuda(t["feats"], t["inv"], t["w"], epi,
                                   n_split=4)
    torch.testing.assert_close(
        got, tref.spconv_fod_fused_ref(t["feats"], t["inv"], t["w"], epi),
        rtol=0, atol=0)
    assert not any(TK.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        TK.spconv_fod_kernel(t["feats"], t["inv"], t["w"], kind="tc",
                             fused=False)
