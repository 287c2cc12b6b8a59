"""Port parity of the sorted MoE FFN's backward on the CPU, and the routing
rule of the weight-gradient kernels.

`sorted_moe_ffn`'s two masked row gathers (tokens into sorted rows, rows
back to assignments) differentiate through the dispatch's inverse tables
(`ops.dispatch_gather`): a gather and a sum over topk, never an
accumulating scatter.  Its gradients for x, gates, w_in, w_gate and w_out
are held against `jax.grad` of the reference's `sorted_moe_ffn(...,
use_kernel=False)` on the same seeded numpy inputs, with capacity drops and
padding rows: max|port - reference| <= tol * max|reference| per gradient,
tol 1e-5 at float32 (the same sums in another order) and 2e-2 at bfloat16
(bf16 roundings at other places in the two frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul import ops as r_gmm
from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
from repro_torch.kernels.grouped_matmul import ops as gmm
from tests.test_torch_gpu import (MOE_CARD_EXPERTS, MOE_CARD_ROW_TILE,
                                  sorted_moe_card_inputs)
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit

T, D, F, E, TOPK, ROW_TILE = 40, 16, 24, 4, 2, 8
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAMES = ("x", "gates", "w_in", "w_gate", "w_out")


def _inputs(skew: bool):
    """Seeded numpy inputs; with `skew`, 70 % of the assignments' first
    choice goes to expert 3, so at a small capacity it drops assignments
    while the other experts leave padding rows."""
    rng = np.random.default_rng(11 + skew)
    idx = np.stack([rng.permutation(E)[:TOPK] for _ in range(T)])
    if skew:
        hot = rng.random(T) < 0.7
        idx[hot] = np.where(idx[hot] == 3, idx[hot][:, ::-1], idx[hot])
        idx[hot, 0] = 3
    gates = rng.random((T, TOPK))
    gates /= gates.sum(-1, keepdims=True)
    arrays = {"x": rng.normal(size=(T, D)), "gates": gates,
              "w_in": rng.normal(size=(E, D, F)) / 4,
              "w_gate": rng.normal(size=(E, D, F)) / 4,
              "w_out": rng.normal(size=(E, F, D)) / 5}
    cot = rng.normal(size=(T, D)).astype(np.float32)
    return idx.astype(np.int32), arrays, cot


def _reference_grads(idx, arrays, cot, dtype, capacity_factor,
                     row_tile=ROW_TILE):
    def loss(x, gates, w_in, w_gate, w_out):
        out = r_gmm.sorted_moe_ffn(
            x, jnp.asarray(idx), gates, w_in, w_out, w_gate=w_gate,
            capacity_factor=capacity_factor, row_tile=row_tile,
            use_kernel=False)
        return jnp.sum(out.astype(jnp.float32) * cot)

    args = [jnp.asarray(np.asarray(arrays[n], np.float32),
                        getattr(jnp, dtype)) for n in NAMES]
    grads = jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    return {n: np.asarray(g, np.float32) for n, g in zip(NAMES, grads)}


def _port(idx, arrays, dtype, capacity_factor, row_tile=ROW_TILE):
    leaves = {n: torch.from_numpy(np.asarray(arrays[n], np.float32)).to(
        getattr(torch, dtype)).requires_grad_() for n in NAMES}
    out = gmm.sorted_moe_ffn(
        leaves["x"], torch.from_numpy(idx), leaves["gates"], leaves["w_in"],
        leaves["w_out"], w_gate=leaves["w_gate"],
        capacity_factor=capacity_factor, row_tile=row_tile)
    return out, leaves


def _assert_grads_match(want, leaves, cot, out, dtype):
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for n in NAMES:
        got = leaves[n].grad
        assert got is not None and got.dtype == getattr(torch, dtype), n
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(got.float().numpy() - want[n]).max())
        assert scale > 0 and err <= GRAD_TOL[dtype] * scale, (n, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skew,capacity_factor", [
    (False, 1.25),     # padding rows, no drops
    (True, 0.5)])      # drops on expert 3, padding rows on the others
def test_sorted_moe_ffn_gradients_match_reference(skew, capacity_factor,
                                                  dtype):
    idx, arrays, cot = _inputs(skew)
    # the case holds what it claims: drops and padding rows as stated
    cap = gmm._round_up(int(T * TOPK * capacity_factor / E) + 1, ROW_TILE)
    disp = gmm.make_dispatch(torch.from_numpy(idx), E, cap, ROW_TILE)
    assert bool((disp.dest_row < 0).any()) == skew
    assert bool((disp.src_token < 0).any())
    want = _reference_grads(idx, arrays, cot, dtype, capacity_factor)
    out, leaves = _port(idx, arrays, dtype, capacity_factor)
    _assert_grads_match(want, leaves, cot, out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_moe_ffn_gradients_match_reference_on_the_card_inputs(dtype):
    """The inputs of tests/test_torch_gpu.py's card-against-CPU backward
    test (T 200, D 64, F 96, 128-row tiles, default capacity): the CPU's
    gradients there are held to the reference's here, so the card's are
    tied to `jax.grad` on the same inputs."""
    idx, arrays, cot = sorted_moe_card_inputs()
    t, topk = idx.shape
    cap = gmm._round_up(int(t * topk * 1.25 / MOE_CARD_EXPERTS) + 1,
                        MOE_CARD_ROW_TILE)
    disp = gmm.make_dispatch(torch.from_numpy(idx), MOE_CARD_EXPERTS, cap,
                             MOE_CARD_ROW_TILE)
    assert bool((disp.dest_row < 0).any())      # drops on expert 3
    assert bool((disp.src_token < 0).any())     # padding rows elsewhere
    want = _reference_grads(idx, arrays, cot, dtype, 1.25, MOE_CARD_ROW_TILE)
    out, leaves = _port(idx, arrays, dtype, 1.25, MOE_CARD_ROW_TILE)
    _assert_grads_match(want, leaves, cot, out, dtype)


def _graph_nodes(out):
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(nxt for nxt, _ in node.next_functions)
    return {type(node).__name__ for node in seen}


@pytest.mark.parametrize("skew,capacity_factor", [(False, 1.25), (True, 0.5)])
def test_sorted_moe_ffn_graph_has_no_index_backward(skew, capacity_factor):
    """Both gathers differentiate through the inverse tables: no
    IndexBackward0 (an accumulating index_put_) anywhere in the graph."""
    idx, arrays, _ = _inputs(skew)
    out, _ = _port(idx, arrays, "float32", capacity_factor)
    names = _graph_nodes(out)
    assert "IndexBackward0" not in names
    assert "_DispatchGatherBackward" in names


def test_sorted_moe_ffn_forward_is_the_masked_index_gather():
    """The forward is bit-equal to the masked index gathers it replaces,
    and builds no inverse table when no gradient is asked."""
    idx, arrays, _ = _inputs(True)
    x = torch.from_numpy(np.asarray(arrays["x"], np.float32))
    ws = [torch.from_numpy(np.asarray(arrays[n], np.float32))
          for n in ("w_in", "w_out", "w_gate")]
    gates = torch.from_numpy(np.asarray(arrays["gates"], np.float32))
    cap = gmm._round_up(int(T * TOPK * 0.5 / E) + 1, ROW_TILE)
    disp = gmm.make_dispatch(torch.from_numpy(idx), E, cap, ROW_TILE)
    src, dest = disp.src_token.long(), disp.dest_row.long()
    xs = torch.where((src >= 0)[:, None], x[src.clamp(min=0)],
                     torch.zeros(()))
    h = torch.nn.functional.silu(
        gmm.grouped_matmul(xs, disp.tile_eid, ws[2], ROW_TILE)) * \
        gmm.grouped_matmul(xs, disp.tile_eid, ws[0], ROW_TILE)
    y = gmm.grouped_matmul(h, disp.tile_eid, ws[1], ROW_TILE)
    picked = torch.where((dest >= 0)[..., None], y[dest.clamp(min=0)],
                         torch.zeros(()))
    want = (picked * gates[..., None]).sum(dim=1)
    with torch.no_grad():
        got = gmm.sorted_moe_ffn(x, torch.from_numpy(idx), gates, ws[0],
                                 ws[1], w_gate=ws[2], capacity_factor=0.5,
                                 row_tile=ROW_TILE)
    assert torch.equal(got, want)


def test_assignment_of_rows_inverts_dest_row():
    idx, _, _ = _inputs(True)
    cap = gmm._round_up(int(T * TOPK * 0.5 / E) + 1, ROW_TILE)
    disp = gmm.make_dispatch(torch.from_numpy(idx), E, cap, ROW_TILE)
    inv = gmm._assignment_of_rows(disp)[:, 0]
    assert inv.shape == (disp.n_rows,)
    flat = disp.dest_row.reshape(-1).long()
    kept = torch.nonzero(flat >= 0)[:, 0]
    assert torch.equal(inv[flat[kept]], kept)
    assert torch.equal(inv >= 0, disp.src_token >= 0)
    assert torch.equal(inv[inv >= 0] // TOPK,
                       disp.src_token[inv >= 0].long())


@pytest.mark.parametrize("dtype,cin,cout,row_tile,kind", [
    ("bfloat16", 1024, 512, 128, "wgmma"),    # w_in / w_gate at the step
    ("bfloat16", 512, 1024, 128, "wgmma"),    # w_out
    ("bfloat16", 200, 136, 64, "wgmma"),      # tails, 64-row tiles
    ("bfloat16", 70, 512, 128, "fma"),        # Cin not of 8
    ("bfloat16", 512, 70, 128, "fma"),        # Cout not of 8
    ("bfloat16", 1024, 512, 16, "fma"),       # a K step crosses row tiles
    ("bfloat16", 1024, 512, 96, "fma"),
    ("float32", 1024, 512, 128, "fma"),       # float32 stays exact: no TF32
    ("float32", 512, 1024, 64, "fma")])
def test_dw_variant_is_chosen_by_dtype_and_shape(dtype, cin, cout, row_tile,
                                                 kind):
    assert GM.dw_variant(getattr(torch, dtype), cin, cout, row_tile) == kind


@pytest.mark.parametrize("entry", ["grouped_matmul_dw_cuda",
                                   "grouped_matmul_dw_wgmma",
                                   "grouped_matmul_dw_fma"])
def test_dw_cpu_tensors_take_the_plain_version(entry):
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_dw_ref
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(256, 24)).astype(np.float32))
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    eid = torch.tensor([2, 0, 2, -1], dtype=torch.int32)
    before = dict(GM.LAUNCHES)
    got = getattr(GM, entry)(x, dy, eid, 3, 64)
    assert GM.LAUNCHES == before
    torch.testing.assert_close(got, grouped_matmul_dw_ref(x, dy, eid, 3, 64),
                               rtol=0, atol=0)
