"""Port parity, end to end, of the LM serving path on reduced
granite-moe-1b-a400m (4 layers, d_model 64, 4 / 2 heads, 8 experts top-4,
vocab 256): the reference's weights carried across by `load_jax_params`,
against the reference under `jax.jit`.

float32: prefill logits and K/V states, decode logits and the updated
cache within atol = rtol = 1e-4 (float32 sums in another order), generated
tokens equal.  bfloat16: XLA and PyTorch round at other places, so where
two experts' router logits tie to within bf16 precision the two may route a
token differently (top-4 of 8 experts over d_model 64 ties often).  The
bf16 check therefore holds (a) the first routing difference of each
sequence to a near tie (a gap between the top-k-th and the next router
logit below 2^-6 of the token's largest router logit: two bf16 roundings),
and (b) with the reference's routing imposed on the port, every prefill
and decode logit to within 2e-2 of the reference's.  On the CPU every
kernel wrapper takes its plain version: no launch is counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import moe as RM
from repro.models import registry as RR
from repro.serve.lm import ServeConfig as RServeConfig
from repro.serve.lm import ServeEngine as RServeEngine
from repro_torch.configs import get as tget
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_decode import flash_decode as FD
from repro_torch.kernels.grouped_matmul import grouped_matmul as GM
from repro_torch.models import moe as TM
from repro_torch.models import registry as TR
from repro_torch.models.params import flatten_tree, load_jax_params
from repro_torch.serve.lm import ServeConfig, ServeEngine

ARCH = "granite-moe-1b-a400m"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NEAR_TIE = 2.0 ** -6     # router-logit gap, relative to the largest logit
B, S, MAX_LEN = 2, 12, 64


@pytest.fixture(scope="module")
def granite():
    """(reference model, reference params, port model, port params)."""
    rcfg = RC.get(ARCH, reduced=True)
    rmodel = RR.build(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.key(0))
    tmodel = TR.build(tget(ARCH, reduced=True))
    module = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(module, jax.tree_util.tree_map(np.asarray, rparams))
    return rmodel, rparams, tmodel, module


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _batches(prompts):
    pos = np.broadcast_to(np.arange(S), (B, S))
    rb = {"tokens": jnp.asarray(prompts), "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(prompts).long(),
          "positions": torch.from_numpy(np.ascontiguousarray(pos)).long()}
    return rb, tb


def _reference_steps(rmodel, rparams, prompts, dtype):
    """The reference's prefill, its states placed in a MAX_LEN cache, and
    one decode step at position S with the prefill's greedy token."""
    rb, _ = _batches(prompts)
    cast = jax.tree_util.tree_map(lambda x: x.astype(dtype), rparams)
    logits, states, aux = jax.jit(rmodel.prefill)(cast, rb)
    init = rmodel.init_state(B, MAX_LEN, dtype)
    cache = jax.tree_util.tree_map(
        lambda d, s: d.at[:, :, :S].set(s.astype(d.dtype)), init, states)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    db = {"tokens": tok[:, None], "positions": jnp.full((B, 1), S, jnp.int32),
          "cache_pos": jnp.full((B,), S, jnp.int32)}
    dlogits, dstates, _ = jax.jit(rmodel.decode)(cast, db, cache)
    return ([np.asarray(x, np.float32) for x in (logits, aux, dlogits)],
            jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   (states, dstates)), np.asarray(tok))


def _port_steps(tmodel, module, prompts, dtype, tok=None):
    """The port's prefill and one decode step, as `_reference_steps`; the
    decode step takes `tok` (B,) where given, else the greedy token."""
    _, tb = _batches(prompts)
    eng = ServeEngine(tmodel, module, ServeConfig(
        max_len=MAX_LEN, cache_dtype=dtype, compute_dtype=dtype),
        device="cpu")
    logits, states, aux = tmodel.prefill(eng.params, tb)
    cache = eng.place_states(states, B)
    tok = logits[:, -1].argmax(-1) if tok is None else torch.from_numpy(
        np.array(tok)).long()
    db = {"tokens": tok[:, None], "positions": torch.full((B, 1), S),
          "cache_pos": torch.full((B,), S)}
    dlogits, dstates, _ = tmodel.decode(eng.params, db, cache)
    return ([x.float().numpy() for x in (logits, aux, dlogits)],
            (states, dstates), tok.numpy())


def test_param_tree_keys_and_shapes_match_reference(granite):
    _, rparams, tmodel, module = granite
    want = {k: np.shape(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, rparams))}
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == want
    # the bodies stay stacked on a leading n_bodies axis, as jax.vmap made them
    assert got["layers.sub0.ffn.w_in"] == (4, 8, 64, 32)
    assert got["layers.sub0.mix.wq.w"] == (4, 64, 64)


def test_prefill_and_decode_match_reference_f32(granite, prompts):
    rmodel, rparams, tmodel, module = granite
    before = (FA.LAUNCHES["flash_attention"], FD.LAUNCHES["flash_decode"],
              GM.LAUNCHES["grouped_matmul"])
    (rl, raux, rdl), (rstates, rdstates), rtok = _reference_steps(
        rmodel, rparams, prompts, jnp.float32)
    (tl, taux, tdl), (tstates, tdstates), ttok = _port_steps(
        tmodel, module, prompts, torch.float32)
    np.testing.assert_allclose(tl, rl, **TOL)
    np.testing.assert_allclose(taux, raux, **TOL)
    np.testing.assert_array_equal(ttok, rtok)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tstates["sub0"], name).numpy(),
            getattr(rstates["sub0"], name), **TOL)
        np.testing.assert_allclose(
            getattr(tdstates["sub0"], name).numpy(),
            getattr(rdstates["sub0"], name), **TOL)
    np.testing.assert_allclose(tdl, rdl, **TOL)
    assert (FA.LAUNCHES["flash_attention"], FD.LAUNCHES["flash_decode"],
            GM.LAUNCHES["grouped_matmul"]) == before


def test_prefill_and_decode_match_reference_bf16(granite, prompts,
                                                 monkeypatch):
    rmodel, rparams, tmodel, module = granite
    topk = 4
    # the reference's routing, in call order (4 prefill, 4 decode layers),
    # pulled to the host from inside its jitted layer scan
    rroutes = []
    rroute = RM.route

    def recorded(p, cfg, x2d):
        out = rroute(p, cfg, x2d)
        jax.debug.callback(lambda i: rroutes.append(np.asarray(i)), out[1],
                           ordered=True)
        return out
    monkeypatch.setattr(RM, "route", recorded)
    (rl, _, rdl), _, rtok = _reference_steps(rmodel, rparams, prompts,
                                             jnp.bfloat16)
    assert len(rroutes) == 8

    # (a) the port's own routing differs only at near ties
    troute, seen = TM.route, []

    def own(p, cfg, x2d):
        out = troute(p, cfg, x2d)
        seen.append((out[1].numpy(),
                     (x2d @ p["router"]["w"]).float().numpy()))
        return out
    monkeypatch.setattr(TM, "route", own)
    _port_steps(tmodel, module, prompts, torch.bfloat16, tok=rtok)
    first = {}                              # sequence -> (position, layer)
    for layer, ((idx, _), want) in enumerate(zip(seen, rroutes)):
        diff = (np.sort(idx, -1) != np.sort(want, -1)).any(-1)
        for t in np.flatnonzero(diff):
            b, pos = divmod(int(t), S if layer < 4 else 1)
            pos += 0 if layer < 4 else S
            if (pos, layer) < first.get(b, (S + 1, 0)):
                first[b] = (pos, layer)
    for b, (pos, layer) in first.items():
        t = b * S + pos if layer < 4 else b
        lg = np.sort(seen[layer][1][t])[::-1]
        assert lg[topk - 1] - lg[topk] < NEAR_TIE * np.abs(lg).max(), (
            f"sequence {b} routes position {pos} differently at call "
            f"{layer} without a near tie")

    # (b) with the reference's routing imposed, the logits agree
    calls = iter(rroutes)

    def imposed(p, cfg, x2d):
        gates, idx, aux = troute(p, cfg, x2d)
        idx = torch.from_numpy(np.array(next(calls))).long()
        probs = torch.softmax((x2d @ p["router"]["w"]).float(), dim=-1)
        g = probs.gather(1, idx)
        return (g / g.sum(-1, keepdim=True)).to(x2d.dtype), idx, aux
    monkeypatch.setattr(TM, "route", imposed)
    (tl, _, tdl), _, _ = _port_steps(tmodel, module, prompts, torch.bfloat16,
                                     tok=rtok)
    np.testing.assert_allclose(tl, rl, **BF16_TOL)
    np.testing.assert_allclose(tdl, rdl, **BF16_TOL)


def test_generate_matches_reference_tokens_f32(granite, prompts):
    rmodel, rparams, tmodel, module = granite
    want = RServeEngine(rmodel, rparams, RServeConfig(
        max_len=MAX_LEN, cache_dtype=jnp.float32,
        compute_dtype=jnp.float32)).generate(prompts, max_new_tokens=6)
    eng = ServeEngine(tmodel, module, ServeConfig(
        max_len=MAX_LEN, cache_dtype=torch.float32,
        compute_dtype=torch.float32), device="cpu")
    got = eng.generate(prompts, max_new_tokens=6)
    assert got.dtype == np.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_past_max_len_matches_reference(granite, prompts):
    """Decoding past the cache's last slot: the reference's
    dynamic_update_slice clamps the write into slot max_len - 1 and keeps
    going; the port writes the same slot and returns the same tokens."""
    rmodel, rparams, tmodel, module = granite
    max_len = S + 2
    want = RServeEngine(rmodel, rparams, RServeConfig(
        max_len=max_len, cache_dtype=jnp.float32,
        compute_dtype=jnp.float32)).generate(prompts, max_new_tokens=6)
    eng = ServeEngine(tmodel, module, ServeConfig(
        max_len=max_len, cache_dtype=torch.float32,
        compute_dtype=torch.float32), device="cpu")
    got = eng.generate(prompts, max_new_tokens=6)
    assert got.dtype == np.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_device_policy(granite, monkeypatch):
    _, _, tmodel, module = granite
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: ServeEngine(tmodel, module, ServeConfig()),
                 lambda: tmodel.init(gen),
                 lambda: tmodel.init_state(1, 8),
                 lambda: ServeEngine(tmodel, module, ServeConfig(),
                                     device="cuda")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    eng = ServeEngine(tmodel, module, ServeConfig(max_len=16), device="cpu")
    assert eng.device.type == "cpu"
    assert eng.params["layers"]["sub0"]["mix"]["wq"]["w"].dtype == \
        torch.bfloat16
    out = eng.generate(np.zeros((1, 3), np.int32), max_new_tokens=2)
    assert out.shape == (1, 2) and ((out >= 0) & (out < 256)).all()


def test_unported_paths_raise():
    """The expert-parallel MoE takes a mesh and refuses an expert count
    its model axis cannot split (the reference asserts); the audio family
    builds the encoder-decoder; M-RoPE sections that do not cover
    head_dim / 2 raise on (B, S, 3) positions, where the reference
    asserts, and (B, S) positions take plain RoPE."""
    from repro.models import layers as RL
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.models import encdec as TED
    from repro_torch.models import moe as TM
    gran = tget(ARCH, reduced=True)
    with pytest.raises(ValueError, match="8 experts cannot be split"):
        TM.moe_apply(None, gran, torch.zeros((2, 4, gran.d_model)),
                     impl="ep", mesh=AbstractMesh((1, 3), ("data", "model")))
    audio = TR.build(tget("seamless-m4t-medium", reduced=True))
    assert audio.init.__module__ == TR.__name__ and \
        audio.init.__qualname__.startswith("_build_encdec")
    params = audio.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k.split(".")[0] for k in params.state_dict()} == {
        "embed", "enc_layers", "enc_norm", "dec_layers", "final_norm",
        "lm_head"}
    assert isinstance(audio.init_state(1, 8, torch.float32, device="cpu"),
                      TED.DecLayerState)
    cfg = tget(ARCH, reduced=True).replace(mrope=True,
                                           mrope_sections=(2, 3, 4))
    model = TR.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="mrope_sections"):
        model.prefill(params, {"tokens": tokens,
                               "positions": torch.zeros((1, 2, 3),
                                                        dtype=torch.int64)})
    with pytest.raises(AssertionError):
        RL._rope_angles(jnp.zeros((1, 2, 3)), 16, 1e4, (2, 3, 4))
    logits, _, _ = model.prefill(params, {
        "tokens": tokens, "positions": torch.arange(2).expand(1, 2)})
    assert logits.shape == (1, 2, cfg.vocab_size)


@pytest.mark.parametrize("change,named", [
    (dict(mrope=True), "mrope"),
    (dict(norm="layernorm"), "layernorm")])
def test_unported_config_features_raise(change, named):
    """The two config features this suite once held unported now run: each
    alone on reduced granite (M-RoPE with sections (2, 3, 3) of head_dim
    16 and distinct (t, h, w) ids; layernorm leaves with a scale and a
    bias) against the reference at init (the same parameter tree), state
    init (equal states) and apply (float32 train logits within 1e-4 x
    max|reference|, the reference's routing imposed; the prefill's logits
    equal to the train logits)."""
    from repro_torch.data.synthetic import token_batch
    from tests.test_torch_configs import _impose, _recorded_routes
    from tests.torch_parity import jit, reference_tree
    if named == "mrope":
        change = dict(change, mrope_sections=(2, 3, 3))
    cfg = tget(ARCH, reduced=True).replace(**change)
    rmodel = RR.build(RC.get(ARCH, reduced=True).replace(**change))
    tmodel = TR.build(cfg)
    module = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    load_jax_params(module, jax.tree_util.tree_map(np.asarray, rparams))
    norm_keys = {k.rsplit(".", 1)[1] for k in module.state_dict()
                 if k.startswith("final_norm.")}
    assert norm_keys == ({"scale", "bias"} if named == "layernorm"
                         else {"scale"})
    want_state = jax.tree_util.tree_leaves(rmodel.init_state(1, 8,
                                                             jnp.float32))
    got_state = [x for _, x in flatten_tree(tmodel.init_state(
        1, 8, torch.float32, device="cpu"))]
    assert len(got_state) == len(want_state)
    for got_leaf, want_leaf in zip(got_state, want_state):
        np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(want_leaf))
    batch = token_batch(3, 0, B, S, cfg.vocab_size)
    if named == "mrope":
        batch["positions"] = np.random.default_rng(5).integers(
            0, 3 * S, (B, S, 3)).astype(np.int32)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        want, routes = _recorded_routes(rmodel, rparams, rb, mp)
        _impose(routes, mp)
        with torch.no_grad():
            got, _ = tmodel.train_logits(module, tb)
            pre, _, _ = tmodel.prefill(module, tb)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    torch.testing.assert_close(pre, got, rtol=0, atol=0)


@pytest.mark.parametrize("change,named", [
    (dict(ssm_type="xlstm", slstm_every=2), "xlstm"),
    (dict(sandwich_norm=True), "sandwich_norm"),
    (dict(sliding_window=8, local_global=True), "local_global"),
    (dict(embed_scale=True), "embed_scale"),
    (dict(tie_embeddings=True), "tie_embeddings"),
    (dict(final_softcap=30.0), "final_softcap")])
def test_config_feature_alone_matches_reference(change, named):
    """Each of the features this slice ports, alone on reduced granite:
    the float32 forward of 12 positions (the local_global window of 8
    binds) within 1e-4 x max|reference|, and greedy tokens from 4-token
    prompts equal (the local layers' 8-slot ring wraps)."""
    from repro_torch.data.synthetic import token_batch
    from tests.test_torch_configs import _impose, _recorded_routes
    from tests.torch_parity import jit, reference_tree
    cfg = tget(ARCH, reduced=True).replace(**change)
    rmodel = RR.build(RC.get(ARCH, reduced=True).replace(**change))
    tmodel = TR.build(cfg)
    module = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    load_jax_params(module, jax.tree_util.tree_map(np.asarray, rparams))
    assert ("lm_head.w" in module.state_dict()) != cfg.tie_embeddings
    batch = token_batch(3, 0, B, S, cfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        if cfg.n_experts and cfg.ssm_type is None:
            want, routes = _recorded_routes(rmodel, rparams, rb, mp)
            _impose(routes, mp)
        else:
            want, _ = jit(rmodel.train_logits)(rparams, rb)
        with torch.no_grad():
            got, _ = tmodel.train_logits(module, {
                k: torch.from_numpy(v) for k, v in batch.items()})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    prompts = np.random.default_rng(2).integers(0, 256, (B, 4)) \
        .astype(np.int32)
    rgen = RServeEngine(rmodel, rparams, RServeConfig(
        max_len=16, cache_dtype=jnp.float32,
        compute_dtype=jnp.float32)).generate(prompts, max_new_tokens=8)
    tgen = ServeEngine(tmodel, module, ServeConfig(
        max_len=16, cache_dtype=torch.float32, compute_dtype=torch.float32),
        device="cpu").generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(tgen, np.asarray(rgen))


def _init_as_before(cfg, dtype):
    """`lm_init`'s earlier algorithm: every leaf drawn in float32, each
    body's dict kept, the bodies stacked, then the whole tree cast."""
    from repro_torch import nn
    from repro_torch.models import layers as TL
    from repro_torch.models import lm as TLM
    gen = torch.Generator().manual_seed(0)
    n = cfg.n_layers // cfg.block_pattern
    params = {"embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model),
              "layers": TLM._stack([TLM.body_init(gen, cfg)
                                    for _ in range(n)]),
              "final_norm": TL.norm_init(cfg, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          use_bias=False)
    return dict(flatten_tree(nn.cast_floating(params, dtype)))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b",
                                  "jamba-v0.1-52b", "xlstm-125m",
                                  "gemma2-2b"])
def test_lm_init_casts_each_leaf_as_drawn_to_the_same_values(arch):
    """`lm_init` casts each leaf as it is drawn and writes it into the
    stacked leaves: the same draws in the same order as drawing the whole
    tree in float32 and casting after, bit for bit."""
    cfg = tget(arch, reduced=True)
    for dtype in (torch.float32, torch.bfloat16):
        got = TR.build(cfg).init(torch.Generator().manual_seed(0), dtype,
                                 device="cpu").state_dict()
        want = _init_as_before(cfg, dtype)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == dtype and torch.equal(got[k], w), k
