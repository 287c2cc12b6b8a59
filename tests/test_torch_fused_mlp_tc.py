"""The tensor-core fused MLP's plan and arithmetic, on the CPU.

`plan_mlp` is a pure function of shapes, type, alignment and the SM count;
`fused_mlp_tf32x3_ref` repeats the kernel's split-float TF32 arithmetic
(csrc/fused_mlp_tc.cu) in plain torch and is held against the reference's
oracle (`repro.kernels.fused_mlp.ref.fused_mlp_ref`, under jax.jit).  The
kernel itself is checked on a card by tests/test_torch_gpu.py.

Tolerance: max|emulation - oracle| <= 1e-5 * max|oracle| in float32, the
rule chip_smoke.py holds every group to (REL_TOL): float32 sums in another
order.  bf16: atol = rtol = 2e-2, the reference's own bf16 tolerance (one
bf16 rounding of the output).  The one-product (hi*hi) scheme must miss the
float32 rule at the 1024-deep and 128-wide layers: the check can tell the
schemes apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp.ref import fused_mlp_ref as oracle
from repro_torch.kernels.fused_mlp import fused_mlp as K
from repro_torch.kernels.fused_mlp.ref import fused_mlp_tf32x3_ref

REL_TOL = 1e-5
N_SM = 132                                  # the H100 SXM's SMs
SEG = {  # PointNet++(s) at 16 x 4096 points: its six groups (widths, rows)
    "sa1": ((3, 32, 32, 64), 131072), "sa2": ((67, 64, 64, 128), 32768),
    "fp2.g0": ((192, 128), 4096), "fp2.g1": ((128, 64), 4096),
    "fp1": ((64, 64, 64), 65536), "head": ((64, 64, 13), 65536)}
POINTNET = {  # PointNet at 8 x 1024 points: feat, 128->1024, the 8-row head
    "feat": ((3, 64, 64, 64, 128), 8192), "feat.1024": ((128, 1024), 8192),
    "head.0": ((1024, 512), 8), "head.1": ((512, 256), 8),
    "head.2": ((256, 40), 8)}
WANT = {"feat.1024": "tc_stream", "head.0": "few_rows", "head.1": "few_rows",
        "head.2": "few_rows"}
DEEP = [(128, 1024), (1024, 512)]           # the one-product control's widths

_oracle = jax.jit(oracle, static_argnums=3)


def operands(widths, rows, seed=0):
    rng = np.random.default_rng(seed + sum(widths))
    x = rng.normal(size=(rows, widths[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * np.sqrt(6.0 / a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [rng.uniform(-0.1, 0.1, size=b).astype(np.float32)
          for b in widths[1:]]
    return x, ws, bs


def reference(x, ws, bs, final_act, dtype=jnp.float32):
    return np.asarray(_oracle(jnp.asarray(x, dtype),
                              [jnp.asarray(w, dtype) for w in ws],
                              [jnp.asarray(b, dtype) for b in bs],
                              final_act), np.float32)


def emulated(x, ws, bs, final_act, dtype=torch.float32, products=None):
    def t(a):
        return torch.from_numpy(a).to(dtype)
    return fused_mlp_tf32x3_ref(t(x), [t(w) for w in ws], [t(b) for b in bs],
                                final_act, products).float().numpy()


@pytest.mark.parametrize("name", sorted(SEG) + sorted(POINTNET))
def test_plan_routes_every_pointnet_group_off_the_fma_kernel(name):
    widths, rows = {**SEG, **POINTNET}[name]
    for dtype in ("float32", "bfloat16"):
        plan = K.plan_mlp(widths, rows, dtype, N_SM)
        assert plan.variant == WANT.get(name, "tc")
        assert 0 < plan.smem <= 232448
        if plan.variant == "tc":          # persistent: at most the row tiles
            assert plan.ctas <= min(-(-rows // plan.rows),
                                    K.CTAS_PER_SM * N_SM)
            assert plan.smem == K.tc_smem(widths, plan.rows, False,
                                          dtype == "bfloat16")


def test_plan_is_a_pure_function_of_shapes():
    x, ws, bs = operands((67, 64, 64, 128), 300)
    a = [torch.from_numpy(v) for v in (x, *ws, *bs)]
    b = [torch.zeros_like(t) for t in a]
    got = {K.plan_for(t[0], t[1:4], t[4:], n_sm=N_SM) for t in (a, b)}
    assert len(got) == 1
    assert got == {K.plan_mlp((67, 64, 64, 128), 300, torch.float32, N_SM)}
    assert K.plan_mlp((67, 64, 64, 128), 300, "float32", N_SM) == got.pop()
    # the SM count moves the grid, not the route
    small = K.plan_mlp(*SEG["sa1"], "float32", 16)
    big = K.plan_mlp(*SEG["sa1"], "float32", N_SM)
    assert small.variant == big.variant == "tc" and small.ctas < big.ctas


def test_few_row_route_spreads_the_weights_over_the_card():
    plan = K.plan_mlp((1024, 512), 8, "float32", N_SM)
    assert plan.variant == "few_rows" and plan.ctas >= 128
    assert plan.cluster <= K.MAX_SPLIT and plan.grid == (16, plan.cluster)
    for rows in (1, 15, 16):
        assert K.plan_mlp((1024, 512), rows, "float32", N_SM).variant == \
            "few_rows"
    assert K.plan_mlp((1024, 512), 17, "float32", N_SM).variant != "few_rows"
    assert K.plan_mlp((256, 7), 8, "float32", N_SM).variant == "tc"


def test_unaligned_operands_take_the_fma_kernel():
    for widths, rows in list(SEG.values()) + list(POINTNET.values()):
        plan = K.plan_mlp(widths, rows, "float32", N_SM, aligned=False)
        assert plan.variant == "fma"
        assert plan.rows == K.row_tile(widths, rows, N_SM)
    x = torch.zeros(4 * 67 + 1)[1:].view(4, 67)      # 4 bytes off 16
    ws, bs = [torch.zeros(67, 64)], [torch.zeros(64)]
    assert K.plan_for(x, ws, bs, n_sm=N_SM).variant == "fma"


@pytest.mark.parametrize("name,widths,final_act", [
    *[(n, SEG[n][0], n != "head") for n in sorted(SEG)],
    *[(f"{a}->{b}", (a, b), True) for a, b in DEEP]])
def test_tf32x3_emulation_matches_the_reference_oracle(name, widths,
                                                       final_act):
    x, ws, bs = operands(widths, 300)
    want = reference(x, ws, bs, final_act)
    got = emulated(x, ws, bs, final_act)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= REL_TOL * scale
    # bf16: two products (x and W exact in TF32), the reference's tolerance
    want16 = reference(x, ws, bs, final_act, jnp.bfloat16)
    got16 = emulated(x, ws, bs, final_act, torch.bfloat16)
    np.testing.assert_allclose(got16, want16, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("widths", DEEP)
def test_one_product_emulation_misses_the_float32_rule(widths):
    x, ws, bs = operands(widths, 300)
    want = reference(x, ws, bs, True)
    one = emulated(x, ws, bs, True, products=1)
    assert np.abs(one - want).max() > REL_TOL * np.abs(want).max()
