"""Port parity of the LM configs registered with the trainer: the four
attention-only ones, qwen1.5-4b and qwen1.5-32b (QKV bias, MHA),
granite-34b (MQA, GELU, a plain MLP) and mixtral-8x7b (MoE top-2, a
sliding window), jamba-v0.1-52b, xlstm-125m and gemma2-2b, and
qwen2-vl-72b and seamless-m4t-medium.

Each config equals the reference's field for field, full and reduced, and
the port registers every config of the reference.  For
the four attention-only configs, at
the reduced size (4 layers, d_model 64, vocab 256) with the port's seeded
init in both packages (`reference_tree`): the float32 forward logits
(`train_logits`, 2 x 16 tokens) within 1e-4 x max|reference|, and one
train step's loss and gradient norm within 1e-4 relative (AdamW eps 1e-4,
as tests/test_torch_train.py).  mixtral runs with the reference's routing
imposed, recorded from its jitted forward (`jax.debug.callback`, as
tests/test_torch_lm.py does), so a near tie cannot route a token apart;
its step runs without remat, so each layer routes once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import moe as RM
from repro.models import registry as RR
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch import configs as TC
from repro_torch.data.synthetic import token_batch
from repro_torch.models import moe as TM
from repro_torch.models import registry as TR
from repro_torch.models.params import load_jax_params
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit, reference_tree

ARCHS = ("qwen1.5-4b", "qwen1.5-32b", "granite-34b", "mixtral-8x7b",
         "jamba-v0.1-52b", "xlstm-125m", "gemma2-2b", "qwen2-vl-72b",
         "seamless-m4t-medium")
# the recurrent and hybrid LMs, gemma2, qwen2-vl and the encoder-decoder
# have files of their own (tests/test_torch_{mamba,xlstm,gemma2,qwen2vl,
# encdec}.py) with their forward and step
ATTENTION_ARCHS = ARCHS[:4]
B, S = 2, 16
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_equal_reference(name):
    for reduced in (False, True):
        got, want = TC.get(name, reduced), RC.get(name, reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert name in TC.list_archs()


def test_unported_configs_stay_unregistered():
    """Every config of the reference is registered in the port (qwen2-vl-72b
    and seamless-m4t-medium the last); a name neither has still raises."""
    assert TC.list_archs() == RC.list_archs()
    assert len(TC.list_archs()) == 12
    for name in ("qwen2-vl-72b", "seamless-m4t-medium"):
        assert TC.get(name).name == name
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        TC.get("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        RC.get("no-such-arch")


def _models(name):
    rmodel = RR.build(RC.get(name, reduced=True))
    tmodel = TR.build(TC.get(name, reduced=True))
    module = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    load_jax_params(module, jax.tree_util.tree_map(np.asarray, rparams))
    return rmodel, rparams, tmodel, module


def _recorded_routes(rmodel, rparams, rbatch, monkeypatch):
    """The reference's expert choice of each MoE layer in call order."""
    routes, real = [], RM.route

    def recorded(p, cfg, x2d):
        out = real(p, cfg, x2d)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), out[1],
                           ordered=True)
        return out
    monkeypatch.setattr(RM, "route", recorded)
    logits, _ = jit(rmodel.train_logits)(rparams, rbatch)
    jax.effects_barrier()
    monkeypatch.setattr(RM, "route", real)
    return logits, routes


def _impose(routes, monkeypatch):
    """The port's route with each layer's experts taken from `routes`,
    cycled in call order; the gates from the port's own probabilities."""
    real, calls = TM.route, {"n": 0}

    def imposed(p, cfg, x2d):
        _, _, aux = real(p, cfg, x2d)
        idx = torch.from_numpy(np.array(routes[calls["n"] % len(routes)]))
        calls["n"] += 1
        probs = torch.softmax((x2d @ p["router"]["w"]).float(), dim=-1)
        g = probs.gather(1, idx.long())
        return (g / g.sum(-1, keepdim=True)).to(x2d.dtype), idx.long(), aux
    monkeypatch.setattr(TM, "route", imposed)
    return calls


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_reduced_forward_and_train_step_match_reference(name, monkeypatch):
    rmodel, rparams, tmodel, module = _models(name)
    cfg = tmodel.cfg
    batch = token_batch(4, 0, B, S, cfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    moe = bool(cfg.n_experts)
    if moe:
        want, routes = _recorded_routes(rmodel, rparams, rb, monkeypatch)
        assert len(routes) == cfg.n_layers
        calls = _impose(routes, monkeypatch)
    else:
        want, _ = jit(rmodel.train_logits)(rparams, rb)
    with torch.no_grad():
        got, _ = tmodel.train_logits(module, tb)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, S, cfg.vocab_size)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)

    # one train step from the same weights: the loss is the forward's
    remat = not moe
    rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32, remat=remat)
    ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=remat)
    rstep = jit(RSTEP.make_train_step(rmodel, rtc, ROPT.AdamWConfig(
        **OPT_CFG)))
    _, _, rmet = rstep(rparams, ROPT.init(rparams), rb)
    tstep = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig(**OPT_CFG))
    _, state, tmet = tstep(module, OPT.init(module), batch)
    assert int(state.step) == 1
    for k in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if moe:
        assert calls["n"] == 2 * cfg.n_layers     # forward, then the step's
