"""Port parity of the xLSTM blocks (`repro_torch.models.xlstm`) and of
xlstm-125m, on its reduced config (4 layers: three mLSTM and one sLSTM;
d_model 64, 4 heads, d_inner 128, vocab 256), against the reference under
`jax.jit` with the port's seeded weights in both packages
(`reference_tree`).

Tolerances (float32 on the CPU): the port's mLSTM chunk runs its max-plus
and linear scans by doubling steps where the reference runs
`lax.associative_scan` (float32 sums in another order), and the sLSTM takes
its input projection for all steps in one product; outputs, states and
logits are held within 1e-4 x max|reference|, one train step's loss and
grad norm within 1e-4 relative (AdamW eps 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import xlstm as RXL
from repro.serve.lm import ServeConfig as RServeConfig
from repro.serve.lm import ServeEngine as RServeEngine
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch.data.synthetic import token_batch
from repro_torch.models import xlstm as XL
from repro_torch.serve.lm import ServeConfig, ServeEngine
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_configs import OPT_CFG, _models
from tests.test_torch_mamba import _close, _x
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit

ARCH = "xlstm-125m"
B, S, H, DK = 2, 16, 4, 8


@pytest.fixture(scope="module")
def xlstm():
    return _models(ARCH)


def _cell_inputs(s, seed=0):
    q, k, v = (_x((B, s, H, DK), seed + i) for i in range(3))
    i_pre, f_pre = (_x((B, s, H), seed + 3 + i) * 3 for i in range(2))
    return q, k, v, i_pre, f_pre


def _state(seed):
    c = _x((B, H, DK, DK), seed)
    n = _x((B, H, DK), seed + 1)
    m = _x((B, H), seed + 2)
    return c, n, m


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_cell_matches_reference_over_chunks(with_state):
    """S = 48 at chunk 16: three chunks carry (C, n, m), from the -1e30
    stabiliser or from a given state; h and the final state within 1e-4 x
    max, and the checkpointed forward equal to the plain one."""
    args = _cell_inputs(48)
    st = _state(7) if with_state else None

    def ref(args, st):
        return RXL.mlstm_cell(*args, state=None if st is None
                              else RXL.MLSTMState(*st), chunk=16)
    rh, rst = jit(ref)(tuple(map(jnp.asarray, args)),
                       None if st is None else tuple(map(jnp.asarray, st)))
    targs = tuple(map(torch.from_numpy, args))
    tst = None if st is None else XL.MLSTMState(*map(torch.from_numpy, st))
    with torch.no_grad():
        th, tnew = XL.mlstm_cell(*targs, state=tst, chunk=16)
    _close(th, rh, what="h")
    for name in ("c", "n", "m"):
        _close(getattr(tnew, name), getattr(rst, name), what=name)
    q = targs[0].clone().requires_grad_()
    gh, _ = XL.mlstm_cell(q, *targs[1:], state=tst, chunk=16)
    assert torch.equal(gh.detach(), th)


def test_mlstm_cell_gradient_matches_reference():
    args = _cell_inputs(32, 11)
    w = _x((B, 32, H, DK), 20)

    def loss(args):
        h, _ = RXL.mlstm_cell(*args, chunk=16)
        return jnp.sum(h * w)
    want = jit(jax.grad(loss))(tuple(map(jnp.asarray, args)))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    h, _ = XL.mlstm_cell(*targs, chunk=16)
    (h * torch.from_numpy(w)).sum().backward()
    for name, t, r in zip("qkvif", targs, want):
        _close(t.grad, r, what=f"d{name}")


def test_mlstm_chunk_must_divide_the_sequence():
    args = _cell_inputs(40)
    with pytest.raises(AssertionError):
        RXL.mlstm_cell(*map(jnp.asarray, args), chunk=16)
    with pytest.raises(ValueError, match="not a multiple of the scan chunk"):
        XL.mlstm_cell(*map(torch.from_numpy, args), chunk=16)


def test_mlstm_decode_continues_prefill():
    """Prefill 16 positions, then 16 decode steps from its state: equal to
    positions 16..31 of one 32-position prefill, and each step to the
    reference's decode step."""
    args = tuple(map(torch.from_numpy, _cell_inputs(32, 30)))
    with torch.no_grad():
        long, _ = XL.mlstm_cell(*args)
        _, st = XL.mlstm_cell(*(a[:, :S] for a in args))
        steps = []
        for t in range(S, 2 * S):
            h, st = XL.mlstm_cell_decode(*(a[:, t:t + 1] for a in args), st)
            steps.append(h)
    _close(torch.cat(steps, 1), long[:, S:].numpy(), what="decode")

    def ref(args):
        _, st = RXL.mlstm_cell(*(a[:, :S] for a in args))
        return RXL.mlstm_cell_decode(*(a[:, S:S + 1] for a in args), st)[0]
    rh = jit(ref)(tuple(jnp.asarray(a.numpy()) for a in args))
    _close(steps[0], rh, what="decode vs reference")


def _block(xlstm, sub):
    _, rparams, tmodel, module = xlstm
    rp = jax.tree_util.tree_map(lambda x: x[0],
                                rparams["layers"][sub]["mix"])
    tp = jax.tree_util.tree_map(lambda x: x[0],
                                module.tree()["layers"][sub]["mix"])
    return tmodel.cfg, rp, tp


@pytest.mark.parametrize("sub,kind", [("sub0", "mlstm"), ("sub3", "slstm")])
def test_block_prefill_and_decode_match_reference(xlstm, sub, kind):
    """A block's prefill output and state, then one decode step from that
    state (the sLSTM's h in the activation dtype, c / n / m float32)."""
    cfg, rp, tp = _block(xlstm, sub)
    rcfg = RC.get(ARCH, reduced=True)
    apply_r = {"mlstm": RXL.mlstm_block_apply,
               "slstm": RXL.slstm_block_apply}[kind]
    apply_t = {"mlstm": XL.mlstm_block_apply,
               "slstm": XL.slstm_block_apply}[kind]
    x = _x((B, S + 1, cfg.d_model), 40)

    def ref(p, x):
        out, st = apply_r(p, rcfg, x[:, :S], mode="prefill")
        step, new = apply_r(p, rcfg, x[:, S:], mode="decode", state=st)
        return out, st, step, new
    rout, rst, rstep, rnew = jit(ref)(rp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, st = apply_t(tp, cfg, xt[:, :S], mode="prefill")
        step, new = apply_t(tp, cfg, xt[:, S:], mode="decode", state=st)
        long, _ = apply_t(tp, cfg, xt, mode="train") if kind == "slstm" \
            else (None, None)
    _close(out, rout, what="prefill")
    _close(step, rstep, what="decode")
    for name in st._fields:
        _close(getattr(st, name), getattr(rst, name), what=f"state {name}")
        _close(getattr(new, name), getattr(rnew, name), what=f"new {name}")
    if kind == "slstm":
        assert new.h.dtype == xt.dtype and new.c.dtype == torch.float32
        _close(step, long[:, S:].numpy(), what="decode vs longer prefill")


def test_init_lm_state_matches_reference(xlstm):
    """Values and dtypes, the -1e30 stabilisers included."""
    rmodel, _, tmodel, _ = xlstm
    want = rmodel.init_state(B, 32, jnp.bfloat16)
    got = tmodel.init_state(B, 32, torch.bfloat16, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    stab = float(np.float32(-1e30))
    assert float(got["sub0"].m.max()) == float(got["sub3"].m.min()) == stab
    assert got["sub3"].h.dtype == torch.bfloat16
    assert got["sub3"].c.dtype == torch.float32


def test_forward_and_train_step_match_reference(xlstm):
    rmodel, rparams, tmodel, module = xlstm
    batch = token_batch(4, 0, B, S, tmodel.cfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = jit(rmodel.train_logits)(rparams, rb)
    with torch.no_grad():
        got, _ = tmodel.train_logits(module, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    _close(got, want, what="logits")
    rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32, remat=True)
    ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=True)
    rstep = jit(RSTEP.make_train_step(rmodel, rtc, ROPT.AdamWConfig(
        **OPT_CFG)))
    _, _, rmet = rstep(rparams, ROPT.init(rparams), rb)
    tstep = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig(**OPT_CFG))
    _, state, tmet = tstep(module, OPT.init(module), batch)
    assert int(state.step) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_generate_matches_reference_tokens(xlstm):
    rmodel, rparams, tmodel, module = xlstm
    prompts = np.random.default_rng(0).integers(0, 256, (B, S)) \
        .astype(np.int32)
    want = RServeEngine(rmodel, rparams, RServeConfig(
        max_len=32, cache_dtype=jnp.float32,
        compute_dtype=jnp.float32)).generate(prompts, max_new_tokens=8)
    eng = ServeEngine(tmodel, module, ServeConfig(
        max_len=32, cache_dtype=torch.float32, compute_dtype=torch.float32),
        device="cpu")
    got = eng.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(want))
