"""Port parity of LM training on the CPU: `data.synthetic.token_batch`,
the losses, AdamW, the model's training entry points, the train step, and
the backward of the two kernel entry points the step runs.

The reference runs under `jax.jit` (`tests.torch_parity.jit`) on the same
seeded numpy inputs.  The train step is held on reduced
granite-moe-1b-a400m (4 layers, d_model 64, 8 experts top-4, vocab 256) at
float32 with 2 x 16 tokens, the same weights in both (`reference_tree`,
`load_jax_params`): loss and metrics within
rtol 1e-4, both moments (the first is 0.1 x the gradient) within rtol
2e-4, every parameter after the step within atol 1e-6 + rtol 1e-4 (float32
sums in another order, before one AdamW step of lr 1e-3 at eps 1e-4).  The
backward of `flash_attention` and `grouped_matmul` (autograd Functions
whose backward runs the kernels' plain versions here) is held against
`torch.autograd` of the plain forward at 1e-5, with out-of-range expert
ids."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data import synthetic as RS
from repro.models import registry as RR
from repro.train import losses as RLO
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch import nn as TN
from repro_torch.configs import get as tget
from repro_torch.data import synthetic as TS
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.grouped_matmul.ref import (grouped_matmul_dw_ref,
                                                   grouped_matmul_ref)
from repro_torch.models import registry as TR
from repro_torch.models.params import flatten_tree, load_jax_params
from repro_torch.train import losses as LO
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit, reference_tree

ARCH = "granite-moe-1b-a400m"
TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 16


def t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("seed,step,batch,seq,vocab,host,n_hosts",
                         [(0, 0, 4, 32, 256, 0, 1), (7, 3, 8, 16, 49155, 1, 2)])
def test_token_batch_bit_equal(seed, step, batch, seq, vocab, host, n_hosts):
    want = RS.token_batch(seed, step, batch, seq, vocab, host, n_hosts)
    got = TS.token_batch(seed, step, batch, seq, vocab, host, n_hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _ce_inputs(seed, v=40, d=8, masked=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, 12, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    lbl = rng.integers(0, v, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32) if masked else None
    return h, w, lbl, mask


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_value_and_grad(masked):
    h, w, lbl, mask = _ce_inputs(1, masked=masked)
    logits = np.einsum("bsd,dv->bsv", h, w)
    m = None if mask is None else jnp.asarray(mask)
    (want, wn), wg = jit(jax.value_and_grad(
        lambda x: RLO.cross_entropy(x, jnp.asarray(lbl), m), has_aux=True))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got, n = LO.cross_entropy(x, t(lbl), None if mask is None else t(mask))
    got.backward()
    close(got, want)
    close(n, wn)
    close(x.grad, wg)


@pytest.mark.parametrize("n_chunks,softcap,transpose", [
    (4, None, False), (3, None, False), (5, 30.0, True), (1, 5.0, False)])
def test_chunked_cross_entropy_value_and_grads(n_chunks, softcap, transpose):
    """12 positions: 4 and 3 chunks divide them, 5 falls back to one."""
    h, w, lbl, mask = _ce_inputs(2)
    w_in = w.T.copy() if transpose else w

    def ref(h, w):
        return RLO.chunked_cross_entropy(
            h, w, jnp.asarray(lbl), jnp.asarray(mask), softcap=softcap,
            n_chunks=n_chunks, transpose_head=transpose)

    (want, wn), (gh, gw) = jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(jnp.asarray(h), jnp.asarray(w_in))
    th, tw = t(h).requires_grad_(), t(w_in).requires_grad_()
    got, n = LO.chunked_cross_entropy(th, tw, t(lbl), t(mask),
                                      softcap=softcap, n_chunks=n_chunks,
                                      transpose_head=transpose)
    got.backward()
    close(got, want)
    close(n, wn)
    close(th.grad, gh)
    close(tw.grad, gw)
    # chunking is only a memory shape: one chunk gives the same loss
    one, _ = LO.chunked_cross_entropy(t(h), t(w_in), t(lbl), t(mask),
                                      softcap=softcap, n_chunks=1,
                                      transpose_head=transpose)
    close(one, want)


def test_zloss_matches_reference():
    logits = np.random.default_rng(3).normal(size=(3, 5, 17)) * 4
    want = jit(lambda x: RLO.zloss(x, 1e-3))(jnp.asarray(logits,
                                                         jnp.float32))
    close(LO.zloss(t(logits, torch.float32), 1e-3), want)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

CFG = dict(lr=1e-2, warmup_steps=10, total_steps=100, min_lr_ratio=0.2,
           weight_decay=0.05, clip_norm=0.5)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 250])
def test_schedule_matches_reference(step):
    want = ROPT.schedule(ROPT.AdamWConfig(**CFG), jnp.int32(step))
    got = OPT.schedule(OPT.AdamWConfig(**CFG), torch.tensor(step,
                                                            dtype=torch.int32))
    close(got, want, rtol=1e-6, atol=1e-9)


def _tree(rng):
    return {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_apply_updates_on_a_carried_state(clip):
    """Two updates from a state already at step 3 with nonzero moments:
    params, moments, step and metrics as the reference's (clipping on and
    off)."""
    rng = np.random.default_rng(4)
    p, m, v = _tree(rng), _tree(rng), _tree(rng)
    v = jax.tree_util.tree_map(np.abs, v)
    grads = [_tree(rng), _tree(rng)]
    cfg = dict(CFG, clip_norm=clip)
    rstate = ROPT.OptState(jnp.int32(3), *(jax.tree_util.tree_map(
        jnp.asarray, x) for x in (m, v)))
    tstate = OPT.OptState(torch.tensor(3, dtype=torch.int32),
                          *(jax.tree_util.tree_map(t, x) for x in (m, v)))
    rp, tp = jax.tree_util.tree_map(jnp.asarray, p), \
        jax.tree_util.tree_map(t, p)
    upd = jit(lambda p, s, g: ROPT.apply_updates(
        p, s, g, ROPT.AdamWConfig(**cfg)))
    for g in grads:
        rp, rstate, rmet = upd(rp, rstate, jax.tree_util.tree_map(
            jnp.asarray, g))
        tp, tstate, tmet = OPT.apply_updates(
            tp, tstate, jax.tree_util.tree_map(t, g), OPT.AdamWConfig(**cfg))
    assert int(tstate.step) == int(rstate.step) == 5
    assert tstate.step.dtype == torch.int32
    for got, want in ((tp, rp), (tstate.m, rstate.m), (tstate.v, rstate.v)):
        for (_, gl), wl in zip(flatten_tree(got),
                               jax.tree_util.tree_leaves(want)):
            close(gl, wl, rtol=1e-5, atol=1e-7)
    assert tmet.keys() == rmet.keys()
    for k in rmet:
        close(tmet[k], rmet[k], rtol=1e-5, atol=1e-9)
    fresh = OPT.init(tp)
    assert int(fresh.step) == 0 and fresh.m["a"]["w"].dtype == torch.float32
    assert not fresh.v["b"][1].any()


# ---------------------------------------------------------------------------
# nn helpers
# ---------------------------------------------------------------------------

def test_nn_training_helpers_match_reference():
    from repro import nn as RN
    want = RN.layernorm_init(6)
    got = TN.layernorm_init(6)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    rcfg = RC.get(ARCH, reduced=True)
    rparams = jax.eval_shape(RR.build(rcfg).init, jax.random.key(0))
    tparams = TR.build(tget(ARCH, reduced=True)).init(torch.Generator(),
                                                      device="cpu")
    assert TN.count_params(tparams) == RN.count_params(rparams)
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = TN.cotangent_cast(x * 2, torch.bfloat16)
    assert torch.equal(y, x * 2)
    g32 = torch.ones(3, dtype=torch.float32, requires_grad=True)
    z = TN.cotangent_cast(g32 * 1, torch.bfloat16)
    (z * torch.tensor([1 / 3, 1.0, 3.0])).sum().backward()
    np.testing.assert_array_equal(
        g32.grad.numpy(), torch.tensor([1 / 3, 1.0, 3.0]).to(
            torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    """The port's seeded init in the reference's tree, carried back by
    `load_jax_params` (which holds keys and shapes equal)."""
    rmodel = RR.build(RC.get(ARCH, reduced=True))
    tmodel = TR.build(tget(ARCH, reduced=True))
    module = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    load_jax_params(module, jax.tree_util.tree_map(np.asarray, rparams))
    return rmodel, rparams, tmodel, module


def test_train_hidden_and_head_info_match_reference(granite):
    rmodel, rparams, tmodel, module = granite
    batch = TS.token_batch(1, 0, B, S, 256)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, waux = jit(rmodel.train_hidden)(rparams, rb)
    got, aux = tmodel.train_hidden(module, tb, remat=True)
    close(got, want)
    close(aux, waux)
    w, transpose, softcap = tmodel.head_info(module)
    rw, rt, rs = rmodel.head_info(rparams)
    close(w, rw, rtol=0, atol=0)
    assert (transpose, softcap) == (rt, rs)
    assert TR.default_moe_impl(tmodel.cfg, "train") == "sorted"


def _step_pair(granite, accum, remat, opt):
    rmodel, rparams, tmodel, module = granite
    batch = TS.token_batch(2, 0, B, S, 256)
    rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32, remat=remat,
                            accum_steps=accum)
    ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=remat,
                           accum_steps=accum)
    rstep = jit(RSTEP.make_train_step(rmodel, rtc,
                                          ROPT.AdamWConfig(**opt)))
    rp, rs, rmet = rstep(rparams, ROPT.init(rparams),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig(**opt))
    tp, ts, tmet = tstep(module, OPT.init(module), batch)
    return (rp, rs, rmet), (tp, ts, tmet)


@pytest.mark.parametrize("accum,remat", [(1, True), (2, False)])
def test_train_step_matches_reference(granite, accum, remat):
    """One step (and a 2-way accumulated one) on 2 x 16 tokens at float32:
    metrics, the optimizer state and every parameter after the step."""
    # eps 1e-4: Adam's first step is g / (|g| + eps), about sign(g) for
    # |g| >> eps, so at the default 1e-8 a gradient entry near 1e-8 turns
    # float32 summation-order noise into a step of up to 2 lr; the
    # gradients themselves are held through the first moment below
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
    (rp, rs, rmet), (tp, ts, tmet) = _step_pair(granite, accum, remat, opt)
    assert set(tmet) == set(rmet) == {"loss", "aux", "n_tokens",
                                      "grad_norm", "lr"}
    for k in rmet:
        close(tmet[k], rmet[k])
    assert int(ts.step) == int(rs.step) == 1
    want = dict(flatten_tree(jax.tree_util.tree_map(np.asarray, rp)))
    got = dict(flatten_tree(tp))
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        close(got[k], want[k], rtol=1e-4, atol=1e-6)
        moved += int((got[k] != granite[3].state_dict()[k]).any())
    assert moved == len(want)                    # every leaf got a gradient
    for got_m, want_m in ((ts.m, rs.m), (ts.v, rs.v)):
        want_m = dict(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                          want_m)))
        for k, g in flatten_tree(got_m):
            close(g, want_m[k], rtol=2e-4, atol=1e-8)


def test_train_config_fields_and_sharding_guard(granite):
    want = {f.name for f in dataclasses.fields(RSTEP.TrainConfig)}
    assert {f.name for f in dataclasses.fields(STEP.TrainConfig)} == want
    ref, port = RSTEP.TrainConfig(), STEP.TrainConfig()
    for f in want - {"compute_dtype", "grad_reduce_dtype"}:
        assert getattr(port, f) == getattr(ref, f)
    assert port.compute_dtype == torch.bfloat16
    # a sharding config is accepted; its placements follow the rules
    from repro_torch.distributed import sharding as SH
    sc = SH.ShardingConfig(SH.AbstractMesh((2, 4), ("data", "model")),
                           fsdp=True)
    assert callable(STEP.make_train_step(granite[2], port,
                                         OPT.AdamWConfig(), sc=sc))
    params = granite[3].tree()
    p_specs, o_specs = STEP.train_step_shardings(params, sc)
    assert p_specs == SH.params_shardings(params, sc) == o_specs.m == \
        o_specs.v and o_specs.step == ()
    assert p_specs["layers"]["sub0"]["mix"]["wq"]["w"] == \
        (None, "data", "model")


def test_bf16_step_with_grad_reduce_dtype_runs(granite):
    """The mixed-precision path on the CPU: bf16 backbone, chunked CE at a
    vocab of 8192, bf16 gradients into float32 moments; finite, and the
    parameters stay float32."""
    cfg = tget(ARCH, reduced=True).replace(vocab_size=8192)
    model = TR.build(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    tc = STEP.TrainConfig(grad_reduce_dtype=torch.bfloat16, ce_chunks=4)
    step = STEP.make_train_step(model, tc, OPT.AdamWConfig(warmup_steps=1))
    batch = TS.token_batch(3, 0, B, S, cfg.vocab_size)
    p, s, met = step(params, OPT.init(params), batch)
    assert all(bool(torch.isfinite(v)) for v in met.values())
    assert float(met["n_tokens"]) == B * S
    assert all(x.dtype == torch.float32 for _, x in flatten_tree(p))
    assert all(x.dtype == torch.float32 for _, x in flatten_tree(s.m))


# ---------------------------------------------------------------------------
# backward of the kernel entry points (their plain versions on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(window=5), dict(softcap=3.0),
                                dict(causal=False, scale=0.3)])
def test_flash_attention_backward_is_plain_autograd(kw):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 4, 11, 8), (2, 2, 11, 8), (2, 2, 11, 8)))
    g = rng.normal(size=(2, 4, 11, 8)).astype(np.float32)
    want = [t(a).requires_grad_() for a in (q, k, v)]
    attention_ref(*want, **kw).backward(t(g))
    got = [t(a).requires_grad_() for a in (q, k, v)]
    out = fa_ops.flash_attention(*got, **kw)
    close(out, attention_ref(*(t(a) for a in (q, k, v)), **kw))
    out.backward(t(g))
    for a, b in zip(got, want):
        close(a.grad, b.grad.numpy(), rtol=1e-5, atol=1e-6)
    # only the inputs that ask for a gradient get one
    q2 = t(q).requires_grad_()
    fa_ops.flash_attention(q2, t(k), t(v), **kw).sum().backward()
    assert q2.grad is not None


@pytest.mark.parametrize("eids", [[0, 2, 2, 1], [3, -1, 7, -6], [1, 1, 1, 1]])
def test_grouped_matmul_backward_is_plain_autograd(eids):
    """dX (the forward on dY with transposed weights) and dW (its own
    kernel's plain version) against autograd of the plain forward; ids
    out of range (-1 wraps, 7 and -6 clamp) and an expert with no tile."""
    rng = np.random.default_rng(6)
    rt, e, cin, cout = 16, 4, 12, 10
    x = rng.normal(size=(len(eids) * rt, cin)).astype(np.float32)
    w = rng.normal(size=(e, cin, cout)).astype(np.float32)
    g = rng.normal(size=(len(eids) * rt, cout)).astype(np.float32)
    eid = torch.tensor(eids, dtype=torch.int32)
    wx, ww = t(x).requires_grad_(), t(w).requires_grad_()
    grouped_matmul_ref(wx, eid, ww, rt).backward(t(g))
    gx, gw = t(x).requires_grad_(), t(w).requires_grad_()
    out = gmm_ops.grouped_matmul(gx, eid, gw, rt)
    close(out, grouped_matmul_ref(t(x), eid, t(w), rt), rtol=0, atol=0)
    GM.reset_launch_counts()
    out.backward(t(g))
    close(gx.grad, wx.grad.numpy(), rtol=1e-5, atol=1e-5)
    close(gw.grad, ww.grad.numpy(), rtol=1e-5, atol=1e-5)
    assert not any(GM.LAUNCHES.values())         # the CPU path counts none
    close(GM.grouped_matmul_dx_cuda(t(g), eid, t(w), rt), wx.grad.numpy(),
          rtol=1e-5, atol=1e-5)
    dw = GM.grouped_matmul_dw_cuda(t(x), t(g), eid, e, rt)
    close(dw, grouped_matmul_dw_ref(t(x), t(g), eid, e, rt), rtol=0, atol=0)
    close(dw, ww.grad.numpy(), rtol=1e-5, atol=1e-5)
    # bf16 operands: the result in bf16, float32 sums inside
    dwb = GM.grouped_matmul_dw_cuda(t(x).bfloat16(), t(g).bfloat16(), eid, e,
                                    rt)
    assert dwb.dtype == torch.bfloat16
    close(dwb, grouped_matmul_dw_ref(t(x).bfloat16().float(),
                                     t(g).bfloat16().float(), eid, e, rt),
          rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="tiles of"):
        GM.grouped_matmul_dw_cuda(t(x), t(g), eid[:3], e, rt)
