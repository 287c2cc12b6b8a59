"""Port parity of gemma2-2b's attention features on its reduced config (4
layers in 2 bodies of local + global attention, window 32, head_dim 16,
attention softcap 50, final softcap 30, sandwich norms, GeGLU, tied
embeddings, vocab 256), against the reference under `jax.jit` with the
port's seeded weights in both packages (`reference_tree`).

float32 on the CPU: logits within 1e-4 x max|reference| (a forward of 48
positions, so the 32-position window binds), one train step's loss and
grad norm within 1e-4 relative (AdamW eps 1e-4), greedy tokens equal with
`max_len` 48 above the window (the local layers' 32-slot ring buffer
wraps), and the chunked cross-entropy over the tied head with the final
softcap equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.lm import ServeConfig as RServeConfig
from repro.serve.lm import ServeEngine as RServeEngine
from repro.train import losses as RLO
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch.data.synthetic import token_batch
from repro_torch.models import lm as LM
from repro_torch.serve.lm import ServeConfig, ServeEngine
from repro_torch.train import losses as LO
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_configs import OPT_CFG, _models
from tests.test_torch_mamba import _close
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit

ARCH = "gemma2-2b"
B, S = 2, 48


@pytest.fixture(scope="module")
def gemma2():
    return _models(ARCH)


def test_layout_and_tied_tree(gemma2):
    _, rparams, tmodel, module = gemma2
    cfg = tmodel.cfg
    assert [(s.kind, s.ffn, s.window) for s in LM.body_layout(cfg)] == \
        [("attn", "dense", 32), ("attn", "dense", None)]
    keys = set(module.state_dict())
    assert not any(k.startswith("lm_head") for k in keys)
    assert {"layers.sub0.norm_mix_post.scale",
            "layers.sub1.norm_ffn_post.scale"} <= keys
    assert "lm_head" not in rparams


def test_forward_and_train_step_match_reference(gemma2):
    rmodel, rparams, tmodel, module = gemma2
    batch = token_batch(4, 0, B, S, tmodel.cfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = jit(rmodel.train_logits)(rparams, rb)
    with torch.no_grad():
        got, _ = tmodel.train_logits(module, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    assert got.dtype == torch.float32
    assert float(got.abs().max()) <= 30.0      # the final softcap
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


def test_chunked_cross_entropy_takes_the_tied_head_and_softcap(gemma2):
    """`train_hidden` + `head_info` (the embedding table, transposed, and
    the final softcap) through the chunked cross-entropy: loss and its
    gradient in the hidden states equal to the reference's."""
    rmodel, rparams, tmodel, module = gemma2
    batch = token_batch(5, 0, B, 16, tmodel.cfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref(params, batch):
        hidden, _ = rmodel.train_hidden(params, batch)
        w, transpose, softcap = rmodel.head_info(params)

        def loss(h):
            return RLO.chunked_cross_entropy(h, w, batch["labels"],
                                             softcap=softcap, n_chunks=4,
                                             transpose_head=transpose)[0]
        return loss(hidden), jax.grad(loss)(hidden)
    rloss, rgrad = jit(ref)(rparams, rb)
    with torch.no_grad():
        hidden, _ = tmodel.train_hidden(module, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    w, transpose, softcap = tmodel.head_info(module)
    assert transpose and softcap == 30.0 and w.shape == (256, 64)
    h = hidden.clone().requires_grad_()
    loss, _ = LO.chunked_cross_entropy(
        h, w, torch.from_numpy(batch["labels"]), softcap=softcap,
        n_chunks=4, transpose_head=transpose)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    _close(h.grad, rgrad, what="d hidden")


def test_init_lm_state_matches_reference(gemma2):
    """The local layer's cache holds its window (a ring), the global
    layer's max_len."""
    rmodel, _, tmodel, _ = gemma2
    want = rmodel.init_state(B, 48, jnp.bfloat16)
    got = tmodel.init_state(B, 48, torch.bfloat16, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [(p, tuple(g.shape)) for p, g in flat_g] == \
        [(p, w.shape) for p, w in flat_w]
    assert got["sub0"].k.shape[2] == 32 and got["sub1"].k.shape[2] == 48
    assert all(g.dtype == torch.bfloat16 for _, g in flat_g)


def test_generate_matches_reference_tokens_past_the_window(gemma2):
    """12 prompt tokens and 30 new ones at max_len 48: the local layers'
    32-slot ring buffer wraps after position 31."""
    rmodel, rparams, tmodel, module = gemma2
    prompts = np.random.default_rng(0).integers(0, 256, (B, 12)) \
        .astype(np.int32)
    want = RServeEngine(rmodel, rparams, RServeConfig(
        max_len=48, cache_dtype=jnp.float32,
        compute_dtype=jnp.float32)).generate(prompts, max_new_tokens=30)
    eng = ServeEngine(tmodel, module, ServeConfig(
        max_len=48, cache_dtype=torch.float32, compute_dtype=torch.float32),
        device="cpu")
    got = eng.generate(prompts, max_new_tokens=30)
    np.testing.assert_array_equal(got, np.asarray(want))
