"""Port parity of qwen2-vl-72b's features on its reduced config (4 layers,
d_model 64, 4 / 2 heads of head_dim 16, M-RoPE sections (2, 3, 3), QKV
bias, vocab 256), against the reference under `jax.jit` with the port's
seeded weights in both packages (`reference_tree`).

M-RoPE is held with distinct (t, h, w) ids: the reference's own smoke
batch gives all three axes one id, which makes M-RoPE plain RoPE and
would hide a swapped section.  The image part of a prompt is a 2 x 2 grid
of patch embeddings at t = 0 with h and w ids from the grid; the text ids
continue from the grid's largest id + 1, equal on all three axes.

float32 on the CPU: `apply_rope` within 1e-6 (float32 cos / sin of
another library), prefill logits over the S_img + S_txt rows and K/V
states within 1e-4 x max|reference|, then decode steps with (B, 1, 3)
positions at the same tolerance and greedy tokens equal; one train step's
loss and grad norm within 1e-4 relative (AdamW eps 1e-4); the launcher's
losses (2-D positions, no patch embeddings, as the reference's trainer
feeds) as `test_torch_launch.py`'s launcher parity holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch.models import layers as TL
from repro_torch.models.params import flatten_tree, tree_map
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_torch_configs import OPT_CFG, _models
from tests.test_torch_launch import launchers_from_one_checkpoint
from tests.test_torch_mamba import _close
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit

ARCH = "qwen2-vl-72b"
B, GRID, S_TXT, NEW, MAX_LEN = 2, 2, 8, 4, 24
S_IMG = GRID * GRID
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def qwen():
    return _models(ARCH)


def mm_positions(batch: int, grid: int, s_txt: int) -> np.ndarray:
    """(B, grid^2 + s_txt, 3) M-RoPE ids: the image's (0, h, w), then the
    text's (n, n, n) from the grid's largest id + 1."""
    h, w = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid, np.int64), h.ravel(), w.ravel()],
                   -1)
    txt = np.repeat(grid + np.arange(s_txt)[:, None], 3, axis=1)
    return np.broadcast_to(np.concatenate([img, txt]),
                           (batch, grid * grid + s_txt, 3)).astype(np.int32)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S_TXT))
            .astype(np.int32),
            "patch_embeds": rng.normal(size=(B, S_IMG, cfg.d_model))
            .astype(np.float32),
            "positions": mm_positions(B, GRID, S_TXT)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def test_mrope_matches_reference_with_distinct_ids():
    """`apply_rope` with (B, S, 3) ids that differ on each axis equals the
    reference's; with one id on all three axes, or with (B, S) ids, M-RoPE
    is plain RoPE; a swapped section order gives another rotation."""
    rng = np.random.default_rng(1)
    hd, sections = 16, (2, 3, 3)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 7, 3)).astype(np.int32)
    want = np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                    sections))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos).long()
    got = TL.apply_rope(tx, tpos, 1e4, sections)
    np.testing.assert_allclose(got.numpy(), want, **ROPE_TOL)
    swapped = TL.apply_rope(tx, tpos, 1e4, (3, 3, 2))
    assert float((swapped - got).abs().max()) > 1e-2
    plain = TL.apply_rope(tx, tpos[..., 0], 1e4)
    assert torch.equal(TL.apply_rope(tx, tpos[..., 0], 1e4, sections), plain)
    same = tpos[..., :1].expand(-1, -1, 3)
    torch.testing.assert_close(TL.apply_rope(tx, same, 1e4, sections), plain,
                               rtol=0, atol=0)
    assert float((got - plain).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="mrope_sections"):
        TL.apply_rope(tx, tpos, 1e4, (2, 3, 4))
    with pytest.raises(ValueError, match="mrope_sections"):
        TL.apply_rope(tx, tpos, 1e4)


def _place(init, states, n):
    """The prefill's K/V in the first `n` slots of a zero cache."""
    def put(dst, src):
        dst[:, :, :n].copy_(src)
        return dst
    return tree_map(put, init, states)


def test_prefill_with_patch_embeds_then_decode_matches_reference(qwen):
    rmodel, rparams, tmodel, module = qwen
    cfg = tmodel.cfg
    batch = _inputs(cfg)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rlogits, rstates, _ = jit(rmodel.prefill)(rparams, rb)
    with torch.no_grad():
        logits, states, _ = tmodel.prefill(module, _torch(batch))
    s = S_IMG + S_TXT
    assert logits.shape == (B, s, cfg.vocab_size)
    _close(logits, rlogits, what="prefill logits")
    for (key, got), want in zip(flatten_tree(states),
                                jax.tree_util.tree_leaves(rstates)):
        _close(got, want, what=key)

    rcache = jax.tree_util.tree_map(
        lambda d, x: d.at[:, :, :s].set(x),
        rmodel.init_state(B, MAX_LEN, jnp.float32), rstates)
    cache = _place(tmodel.init_state(B, MAX_LEN, torch.float32,
                                     device="cpu"), states, s)
    rdecode = jit(rmodel.decode)
    rtok = np.asarray(jnp.argmax(rlogits[:, -1], -1))
    tok = logits[:, -1].argmax(-1)
    np.testing.assert_array_equal(tok.numpy(), rtok)
    next_id = int(batch["positions"][0, -1, 0]) + 1
    for t in range(NEW):
        pos = np.full((B, 1, 3), next_id + t, np.int32)
        cpos = np.full((B,), s + t, np.int32)
        rlog, rcache, _ = rdecode(rparams, {
            "tokens": jnp.asarray(rtok[:, None].astype(np.int32)),
            "positions": jnp.asarray(pos),
            "cache_pos": jnp.asarray(cpos)}, rcache)
        with torch.no_grad():
            dlog, cache, _ = tmodel.decode(module, {
                "tokens": tok[:, None], "positions": torch.from_numpy(pos)
                .long(), "cache_pos": torch.from_numpy(cpos).long()}, cache)
        _close(dlog, rlog, what=f"decode step {t}")
        rtok = np.asarray(jnp.argmax(rlog[:, -1], -1))
        tok = dlog[:, -1].argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), rtok)


def test_train_step_with_patch_embeds_matches_reference(qwen):
    """Labels over the S_img + S_txt rows; remat on."""
    rmodel, rparams, tmodel, module = qwen
    batch = _inputs(tmodel.cfg, seed=2)
    batch["labels"] = np.random.default_rng(3).integers(
        0, tmodel.cfg.vocab_size, (B, S_IMG + S_TXT)).astype(np.int32)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32, remat=True)
    ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=True)
    rstep = jit(RSTEP.make_train_step(rmodel, rtc, ROPT.AdamWConfig(
        **OPT_CFG)))
    _, _, rmet = rstep(rparams, ROPT.init(rparams), rb)
    tstep = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig(**OPT_CFG))
    _, state, tmet = tstep(module, OPT.init(module), _torch(batch))
    assert int(state.step) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_launcher_trains_like_the_reference(capsys, tmp_path):
    """`launch.train.main --arch qwen2-vl-72b --reduced`: `token_batch`'s
    2-D positions take plain RoPE in both packages, and the losses from
    one step-0 checkpoint agree."""
    launchers_from_one_checkpoint(ARCH, capsys, tmp_path)


def test_device_policy(qwen, monkeypatch):
    """Without a card `device=None` raises; the CPU is opt-in."""
    _, _, tmodel, _ = qwen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tmodel.init(gen), lambda: tmodel.init_state(1, 8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    params = tmodel.init(gen, torch.bfloat16, device="cpu")
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    assert {p.device.type for p in params.parameters()} == {"cpu"}
