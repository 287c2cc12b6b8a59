"""Port parity of the encoder-decoder (`models/encdec.py`) on reduced
seamless-m4t-medium (2 encoder + 2 decoder layers, d_model 64, 4 heads of
head_dim 16, layernorm, a plain ReLU MLP, vocab 256), against the
reference under `jax.jit` with the port's seeded weights in both packages
(`reference_tree`).

float32 on the CPU, each within 1e-4 x max|reference| (float32 sums in
another order): `encode`; `encdec_apply` in train mode; in prefill mode
with its stacked self / cross K/V states; decode from the prefill's states
placed in a cache of `max_len` self slots and an `enc_len` != `max_len`
cross cache, against the reference's decode and against the train logits
at the same position (teacher forcing).  One train step's loss and grad
norm within 1e-4 relative (AdamW eps 1e-4), with remat on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as RED
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch.models import encdec as ED
from repro_torch.models.params import flatten_tree, tree_map
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_configs import OPT_CFG, _models
from tests.test_torch_mamba import _close
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit

ARCH = "seamless-m4t-medium"
B, S_ENC, S_DEC, MAX_LEN = 2, 12, 8, 16


@pytest.fixture(scope="module")
def seamless():
    return _models(ARCH)


def _inputs(cfg, s_dec=S_DEC, seed=0):
    rng = np.random.default_rng(seed)
    return {"frame_embeds": rng.normal(size=(B, S_ENC, cfg.d_model))
            .astype(np.float32),
            "enc_positions": np.broadcast_to(np.arange(S_ENC), (B, S_ENC))
            .astype(np.int32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, s_dec))
            .astype(np.int32),
            "positions": np.broadcast_to(np.arange(s_dec), (B, s_dec))
            .astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def test_param_tree_is_the_references(seamless):
    _, rparams, tmodel, module = seamless
    want = {k: np.shape(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, rparams))}
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == want
    # layers stay stacked; layernorm has a bias; the MLP is not gated
    assert got["enc_layers.attn.wq.w"] == (2, 64, 64)
    assert got["dec_layers.cross.wk.w"] == (2, 64, 64)
    assert got["dec_layers.norm_cross.bias"] == (2, 64)
    assert not any(k.endswith("ffn.wg.w") for k in got)


def test_encode_and_train_logits_match_reference(seamless):
    rmodel, rparams, tmodel, module = seamless
    cfg = tmodel.cfg
    batch = _inputs(cfg)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch(batch)
    want_enc = jit(lambda p, f, e: RED.encode(p, cfg, f, e))(
        rparams, rb["frame_embeds"], rb["enc_positions"])
    want, _ = jit(rmodel.train_logits)(rparams, rb)
    with torch.no_grad():
        got_enc = ED.encode(module, cfg, tb["frame_embeds"],
                            tb["enc_positions"])
        got, aux = tmodel.train_logits(module, tb)
    _close(got_enc, want_enc, what="encode")
    assert got.shape == (B, S_DEC, cfg.vocab_size)
    _close(got, want, what="train logits")
    assert float(aux) == 0.0


def test_prefill_then_decode_through_the_cross_cache(seamless, monkeypatch):
    """Prefill S_DEC tokens, then decode tokens S_DEC.. from a cache of
    MAX_LEN self slots and S_ENC (!= MAX_LEN) cross slots: the reference's
    decode logits, and the train logits of the whole sequence at each
    position.  Decode reads the cross cache and never computes it."""
    rmodel, rparams, tmodel, module = seamless
    cfg = tmodel.cfg
    n_new = 3
    full = _inputs(cfg, S_DEC + n_new, seed=1)
    pre = {k: v[:, :S_DEC] if k in ("tokens", "positions") else v
           for k, v in full.items()}
    rlogits, rstates, _ = jit(rmodel.prefill)(
        rparams, {k: jnp.asarray(v) for k, v in pre.items()})
    with torch.no_grad():
        logits, states, _ = tmodel.prefill(module, _torch(pre))
        train, _ = tmodel.train_logits(module, _torch(full))
    _close(logits, rlogits, what="prefill logits")
    _close(logits, train[:, :S_DEC].numpy(), what="prefill vs train")
    assert isinstance(states, ED.DecLayerState)
    assert tuple(states.cross.k.shape) == (cfg.n_layers, B, S_ENC,
                                           cfg.n_heads, 16)
    for (key, got), want in zip(flatten_tree(states),
                                jax.tree_util.tree_leaves(rstates)):
        _close(got, want, what=key)

    rinit = rmodel.init_state(B, MAX_LEN, jnp.float32, enc_len=S_ENC)
    rcache = rinit._replace(
        self_kv=jax.tree_util.tree_map(lambda d, x: d.at[:, :, :S_DEC].set(x),
                                       rinit.self_kv, rstates.self_kv),
        cross=rstates.cross)
    init = tmodel.init_state(B, MAX_LEN, torch.float32, device="cpu",
                             enc_len=S_ENC)
    assert tuple(init.self_kv.k.shape) == (cfg.n_layers, B, MAX_LEN,
                                           cfg.n_kv_heads, 16)
    assert tuple(init.cross.v.shape) == (cfg.n_layers, B, S_ENC,
                                         cfg.n_heads, 16)
    tree_map(lambda d, x: d[:, :, :x.shape[2]].copy_(x), init, states)
    cache = init

    def no_cross_kv(*a):
        raise AssertionError("decode computed the cross K/V")
    monkeypatch.setattr(ED, "cross_kv", no_cross_kv)
    rdecode = jit(rmodel.decode)
    for t in range(S_DEC, S_DEC + n_new):
        db = {"tokens": full["tokens"][:, t:t + 1],
              "positions": full["positions"][:, t:t + 1],
              "cache_pos": np.full((B,), t, np.int32)}
        rlog, rcache, _ = rdecode(rparams, {k: jnp.asarray(v)
                                            for k, v in db.items()}, rcache)
        with torch.no_grad():
            dlog, cache, _ = tmodel.decode(module, _torch(db), cache)
        assert cache is init
        _close(dlog, rlog, what=f"decode {t}")
        _close(dlog[:, 0], train[:, t].numpy(), what=f"decode {t} vs train")
    # the cross cache is the prefill's, untouched
    torch.testing.assert_close(cache.cross.k, states.cross.k, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_matches_reference(seamless, remat):
    rmodel, rparams, tmodel, module = seamless
    batch = _inputs(tmodel.cfg, seed=2)
    batch["labels"] = np.random.default_rng(3).integers(
        0, tmodel.cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32, remat=remat)
    ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=remat)
    rstep = jit(RSTEP.make_train_step(rmodel, rtc, ROPT.AdamWConfig(
        **OPT_CFG)))
    _, _, rmet = rstep(rparams, ROPT.init(rparams), rb)
    tstep = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig(**OPT_CFG))
    _, state, tmet = tstep(module, OPT.init(module), _torch(batch))
    assert int(state.step) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_remat_recomputes_each_decoder_layer(seamless, monkeypatch):
    """With remat the backward runs each decoder layer's forward again;
    the gradients equal those without remat."""
    _, _, tmodel, module = seamless
    batch = _inputs(tmodel.cfg, seed=4)
    batch["labels"] = batch["tokens"]
    calls = {"n": 0}
    real = ED.dec_layer_apply

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ED, "dec_layer_apply", counted)
    grads = {}
    for remat in (False, True):
        calls["n"] = 0
        g, _ = STEP.make_grad_fn(tmodel, STEP.TrainConfig(
            compute_dtype=torch.float32, remat=remat))(
                module.tree(), _torch(batch))
        grads[remat] = dict(flatten_tree(g))
        assert calls["n"] == tmodel.cfg.n_layers * (2 if remat else 1)
    for k, v in grads[False].items():
        torch.testing.assert_close(grads[True][k], v, rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_device_policy(seamless, monkeypatch):
    """Without a card `device=None` raises; the CPU is opt-in; the init is
    in the dtype asked for."""
    _, _, tmodel, _ = seamless
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tmodel.init(gen), lambda: tmodel.init_state(1, 8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    params = tmodel.init(gen, torch.bfloat16, device="cpu")
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    state = tmodel.init_state(1, 8, torch.bfloat16, device="cpu", enc_len=5)
    assert {x.dtype for _, x in flatten_tree(state)} == {torch.bfloat16}
    assert tuple(state.cross.k.shape)[2] == 5
