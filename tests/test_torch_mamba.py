"""Port parity of the mamba block (`repro_torch.models.mamba`) and of the
jamba hybrid that carries it, on reduced jamba-v0.1-52b (one body of 8
sub-layers: 7 mamba and 1 attention, MoE on the odd ones; d_model 64,
d_inner 128, d_state 8, vocab 256), against the reference under `jax.jit`
with the port's seeded weights in both packages (`reference_tree`).

Tolerances (float32 on the CPU): the port's chunk scan composes the
recurrence by doubling steps where the reference runs
`lax.associative_scan`, so its float32 products and sums come in another
order; outputs, states and logits are held within 1e-4 x max|reference|,
one train step's loss and grad norm within 1e-4 relative (AdamW eps 1e-4,
as tests/test_torch_configs.py).  The model-level cases run with the
reference's MoE routing imposed, so a near tie cannot route a token
apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import mamba as RMB
from repro.models import registry as RR
from repro.serve.lm import ServeConfig as RServeConfig
from repro.serve.lm import ServeEngine as RServeEngine
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch.data.synthetic import token_batch
from repro_torch.models import mamba as MB
from repro_torch.serve.lm import ServeConfig, ServeEngine
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_configs import OPT_CFG, _impose, _models, \
    _recorded_routes
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit

ARCH = "jamba-v0.1-52b"
B, S = 2, 16
REL = 1e-4


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def jamba():
    return _models(ARCH)


def _mixer(jamba, sub="sub0"):
    """(reference params, port params) of body 0's mamba sub-layer."""
    _, rparams, _, module = jamba
    rp = jax.tree_util.tree_map(lambda x: x[0],
                                rparams["layers"][sub]["mix"])
    tp = jax.tree_util.tree_map(lambda x: x[0],
                                module.tree()["layers"][sub]["mix"])
    return rp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_matches_reference_over_chunks(jamba, with_h0):
    """S = 48 at chunk 16: three chunks carry the state, from zeros or from
    a given h0; y and h_final within 1e-4 x max, and the checkpointed
    forward (gradients on) equal to the plain one."""
    cfg = jamba[2].cfg
    rp, tp = _mixer(jamba)
    di = cfg.ssm_expand * cfg.d_model
    x = _x((B, 48, di))
    h0 = _x((B, di, cfg.d_state), 1) if with_h0 else None

    def ref(p, x, h0):
        return RMB.selective_scan(p, RC.get(ARCH, reduced=True), x, h0,
                                  chunk=16)
    ry, rh = jit(ref)(rp, jnp.asarray(x),
                      None if h0 is None else jnp.asarray(h0))
    th0 = None if h0 is None else torch.from_numpy(h0)
    with torch.no_grad():
        ty, th = MB.selective_scan(tp, cfg, torch.from_numpy(x), th0,
                                   chunk=16)
    _close(ty, ry, what="y")
    _close(th, rh, what="h_final")
    assert th.dtype == torch.float32
    xg = torch.from_numpy(x).requires_grad_()
    gy, gh = MB.selective_scan(tp, cfg, xg, th0, chunk=16)
    assert torch.equal(gy.detach(), ty) and torch.equal(gh.detach(), th)


def test_selective_scan_gradient_matches_reference(jamba):
    """The chunks' checkpointed backward: d(sum(y * w))/dx against
    jax.grad of the reference's scan."""
    cfg = jamba[2].cfg
    rp, tp = _mixer(jamba)
    di = cfg.ssm_expand * cfg.d_model
    x, w = _x((B, 32, di)), _x((B, 32, di), 2)

    def loss(x):
        y, _ = RMB.selective_scan(rp, RC.get(ARCH, reduced=True), x,
                                  chunk=16)
        return jnp.sum(y * w)
    want = jit(jax.grad(loss))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = MB.selective_scan(tp, cfg, xt, chunk=16)
    (y * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, want, what="dx")


def test_scan_chunk_must_divide_the_sequence(jamba):
    cfg = jamba[2].cfg
    rp, tp = _mixer(jamba)
    di = cfg.ssm_expand * cfg.d_model
    x = _x((1, 40, di))
    with pytest.raises(AssertionError):
        RMB.selective_scan(rp, RC.get(ARCH, reduced=True), jnp.asarray(x),
                           chunk=16)
    with pytest.raises(ValueError, match="not a multiple of the scan chunk"):
        MB.selective_scan(tp, cfg, torch.from_numpy(x), chunk=16)


def test_mamba_decode_continues_prefill(jamba):
    """Prefill 16 positions, then decode position 16 from the prefill's
    state: equal to the 17th output of one 17-position prefill, and to the
    reference's decode step."""
    cfg = jamba[2].cfg
    rp, tp = _mixer(jamba)
    x = _x((B, S + 1, cfg.d_model), 3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        long, _ = MB.mamba_apply(tp, cfg, xt, mode="prefill")
        _, st = MB.mamba_apply(tp, cfg, xt[:, :S], mode="prefill")
        state = MB.init_mamba_state(cfg, B, device="cpu")
        state.conv.copy_(st.conv)
        state.ssm.copy_(st.ssm)
        step, new = MB.mamba_apply(tp, cfg, xt[:, S:], mode="decode",
                                   state=state)
    _close(step, long[:, S:].numpy(), what="decode vs longer prefill")
    assert new.ssm.dtype == torch.float32

    rcfg = RC.get(ARCH, reduced=True)

    def ref(p, x):
        _, st = RMB.mamba_apply(p, rcfg, x[:, :S], mode="prefill")
        st = RMB.MambaState(st.conv.astype(jnp.float32), st.ssm)
        return RMB.mamba_apply(p, rcfg, x[:, S:], mode="decode", state=st)
    rstep, rnew = jit(ref)(rp, jnp.asarray(x))
    _close(step, rstep, what="decode vs reference")
    _close(new.conv, rnew.conv, what="conv state")
    _close(new.ssm, rnew.ssm, what="ssm state")


def test_init_lm_state_matches_reference(jamba):
    rmodel, _, tmodel, _ = jamba
    want = rmodel.init_state(B, 32, jnp.bfloat16)
    got = tmodel.init_state(B, 32, torch.bfloat16, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    # the mamba states stay float32 whatever the cache dtype
    assert got["sub0"].conv.dtype == got["sub0"].ssm.dtype == torch.float32
    assert got["sub4"].k.dtype == torch.bfloat16


def test_forward_and_train_step_match_reference(jamba, monkeypatch):
    rmodel, rparams, tmodel, module = jamba
    cfg = tmodel.cfg
    batch = token_batch(4, 0, B, S, cfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, routes = _recorded_routes(rmodel, rparams, rb, monkeypatch)
    assert len(routes) == 4                      # the four MoE sub-layers
    calls = _impose(routes, monkeypatch)
    with torch.no_grad():
        got, _ = tmodel.train_logits(module, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    _close(got, want, what="logits")

    # one step with remat: the body's recompute routes as its forward
    rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32, remat=True)
    ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=True)
    rstep = jit(RSTEP.make_train_step(rmodel, rtc, ROPT.AdamWConfig(
        **OPT_CFG)))
    _, _, rmet = rstep(rparams, ROPT.init(rparams), rb)
    tstep = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig(**OPT_CFG))
    _, state, tmet = tstep(module, OPT.init(module), batch)
    assert int(state.step) == 1
    for k in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert calls["n"] == 4 + 8                   # forward; step and recompute


def test_generate_matches_reference_tokens(jamba):
    """Greedy generation at float32 (prefill through the chunk scan, then
    decode steps writing the mamba states back into the stacked tree)."""
    rmodel, rparams, tmodel, module = jamba
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


def test_decode_writes_the_mamba_states_back(jamba):
    """A decode step returns the stacked tree it was given, with the mamba
    sub-layers' new states written into it."""
    _, _, tmodel, module = jamba
    prompts = np.random.default_rng(1).integers(0, 256, (B, S))
    eng = ServeEngine(tmodel, module, ServeConfig(
        max_len=32, cache_dtype=torch.float32, compute_dtype=torch.float32),
        device="cpu")
    tb = {"tokens": torch.from_numpy(prompts).long(),
          "positions": torch.arange(S).expand(B, S)}
    with torch.no_grad():
        _, pre, _ = tmodel.prefill(eng.params, tb)
        states = eng.place_states(pre, B)
        before = states["sub0"].ssm.clone()
        db = {"tokens": torch.zeros((B, 1), dtype=torch.long),
              "positions": torch.full((B, 1), S),
              "cache_pos": torch.full((B,), S)}
        _, out, _ = tmodel.decode(eng.params, db, states)
    assert out is states
    assert not torch.equal(states["sub0"].ssm, before)
