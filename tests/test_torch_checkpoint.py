"""Port parity of checkpointing (`repro_torch/checkpoint/store.py`) on the
CPU: the on-disk format is the reference's, so a checkpoint written by
either package restores bit-equal in the other.

The tree is reduced granite-moe-1b-a400m's parameters (the port's seeded
init, laid out as the reference's tree by `reference_tree`), an
`OptState` of seeded moments at step 7, and one bfloat16 leaf, the same
values in both packages.  Also the commit rules (`COMMIT` written last, a
leftover `.tmp` ignored, a shape mismatch raising) and the async
`CheckpointManager`, whose `wait()` returns only once the last queued save
has committed (the reference's returns when its queue is empty, while the
writer may still be writing: a deliberate difference)."""

import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.checkpoint import store as RST
from repro.models import registry as RR
from repro.train import optim as ROPT
from repro_torch.checkpoint import store as ST
from repro_torch.configs import get as tget
from repro_torch.models import registry as TR
from repro_torch.train import optim as OPT
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import reference_tree

ARCH = "granite-moe-1b-a400m"


def _port_tree(template, values: dict, prefix=""):
    """`template`'s nested dict with each leaf values[dotted path]."""
    if isinstance(template, dict):
        return {k: _port_tree(v, values, f"{prefix}{k}.")
                for k, v in template.items()}
    return values[prefix[:-1]]


def _reference_tree(struct, values: dict):
    def leaf(path, shape):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        return jnp.asarray(values[key], shape.dtype)
    return jax.tree_util.tree_map_with_path(leaf, struct)


@pytest.fixture(scope="module")
def trees():
    """(reference tree, port tree) holding the same values."""
    rmodel = RR.build(RC.get(ARCH, reduced=True))
    module = TR.build(tget(ARCH, reduced=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    struct = jax.eval_shape(rmodel.init, jax.random.key(0))
    rng = np.random.default_rng(7)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    m = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    v = {k: rng.random(size=s).astype(np.float32) for k, s in shapes.items()}
    bits = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    ref = {"params": rparams,
           "opt": ROPT.OptState(step=jnp.int32(7),
                                m=_reference_tree(struct, m),
                                v=_reference_tree(struct, v)),
           "half": jnp.asarray(bits.view(jnp.bfloat16))}
    tree = module.tree()
    port = {"params": tree,
            "opt": OPT.OptState(
                step=torch.tensor(7, dtype=torch.int32),
                m=_port_tree(tree, {k: torch.from_numpy(a)
                                    for k, a in m.items()}),
                v=_port_tree(tree, {k: torch.from_numpy(a)
                                    for k, a in v.items()})),
           "half": torch.from_numpy(bits.view(np.int16)).view(
               torch.bfloat16)}
    return ref, port


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as unsigned words of its width."""
    a = ST._gather_for_save(x).raw if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return a.reshape(a.shape or (1,)).view(f"u{a.dtype.itemsize}")


def _flat_port(tree):
    return dict(ST._flatten(tree))


def _flat_ref(tree):
    return dict(RST._flatten(tree)[0])


def _zeros_like_port(port):
    return {"params": jax.tree_util.tree_map(
        torch.zeros_like, port["params"]),
        "opt": OPT.OptState(torch.zeros((), dtype=torch.int32),
                            jax.tree_util.tree_map(torch.zeros_like,
                                                   port["opt"].m),
                            jax.tree_util.tree_map(torch.zeros_like,
                                                   port["opt"].v)),
        "half": torch.zeros_like(port["half"])}


def test_reference_checkpoint_restores_bit_equal_in_the_port(trees,
                                                              tmp_path):
    ref, port = trees
    RST.save(str(tmp_path), 3, ref, extra={"who": "reference"})
    assert ST.latest_step(str(tmp_path)) == 3
    got = ST.restore(str(tmp_path), 3, _zeros_like_port(port), device="cpu")
    assert isinstance(got["opt"], OPT.OptState)
    assert got["half"].dtype == torch.bfloat16
    flat_got, flat_want = _flat_port(got), _flat_port(port)
    assert list(flat_got) == list(flat_want)
    for k, want in flat_want.items():
        assert flat_got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(_bits(flat_got[k]), _bits(want),
                                      err_msg=k)
    assert ST.read_manifest(str(tmp_path), 3)["extra"] == {"who":
                                                           "reference"}


def test_port_checkpoint_restores_bit_equal_in_the_reference(trees,
                                                              tmp_path):
    ref, port = trees
    ST.save(str(tmp_path), 5, port)
    assert RST.latest_step(str(tmp_path)) == 5
    got = RST.restore(str(tmp_path), 5, jax.eval_shape(lambda: ref))
    flat_got, flat_want = _flat_ref(got), _flat_ref(ref)
    assert list(flat_got) == list(flat_want)
    for k, want in flat_want.items():
        assert flat_got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(_bits(flat_got[k]), _bits(want),
                                      err_msg=k)


def test_both_packages_write_the_same_files_and_manifest(trees, tmp_path):
    ref, port = trees
    rdir = RST.save(str(tmp_path / "ref"), 2, ref, extra={"a": 1})
    pdir = ST.save(str(tmp_path / "port"), 2, port, extra={"a": 1})
    assert os.path.basename(rdir) == os.path.basename(pdir) == "step_00000002"
    names = sorted(os.listdir(rdir))
    assert names == sorted(os.listdir(pdir))
    assert "COMMIT" in names and "manifest.json" in names
    assert "opt__m__layers__sub0__ffn__w_in.npy" in names
    assert "opt__step.npy" in names and "half.npy" in names
    with open(os.path.join(rdir, "manifest.json")) as f:
        rman = json.load(f)
    with open(os.path.join(pdir, "manifest.json")) as f:
        pman = json.load(f)
    assert pman == rman
    assert list(pman["leaves"]) == list(rman["leaves"])    # JAX's order
    assert pman["leaves"]["half"] == {"shape": [3, 5], "dtype": "bfloat16"}
    assert pman["leaves"]["opt__step"] == {"shape": [], "dtype": "int32"}
    for n in names:
        if n.endswith(".npy"):
            with open(os.path.join(rdir, n), "rb") as a, \
                    open(os.path.join(pdir, n), "rb") as b:
                assert a.read() == b.read(), n


# ---------------------------------------------------------------------------
# commit and resume rules
# ---------------------------------------------------------------------------

def test_uncommitted_and_tmp_steps_are_ignored(tmp_path):
    root = str(tmp_path)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    ST.save(root, 2, tree)
    d = ST.save(root, 4, tree)
    os.remove(os.path.join(d, "COMMIT"))                  # killed mid-commit
    shutil.copytree(os.path.join(root, "step_00000002"),
                    os.path.join(root, "step_00000009.tmp"))   # mid-write
    for latest in (ST.latest_step, RST.latest_step):
        assert latest(root) == 2
    with pytest.raises(FileNotFoundError, match="no committed"):
        ST.restore(root, 4, tree, device="cpu")
    assert ST.latest_step(str(tmp_path / "missing")) is None
    ST.save(root, 9, tree)                               # replaces the .tmp
    assert ST.latest_step(root) == 9
    assert not os.path.exists(os.path.join(root, "step_00000009.tmp"))


def test_shape_mismatch_raises_and_dtype_follows_like(tmp_path):
    root = str(tmp_path)
    ST.save(root, 1, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                      "n": [torch.tensor(3, dtype=torch.int64)]})
    with pytest.raises(ValueError, match="shape mismatch for w"):
        ST.restore(root, 1, {"w": torch.zeros(3, 2), "n": [torch.zeros(())]},
                   device="cpu")
    got = ST.restore(root, 1, {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                               "n": [torch.zeros((), dtype=torch.int32)]},
                     device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["n"][0].dtype == \
        torch.int32
    assert got["w"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
    assert int(got["n"][0]) == 3


def test_restore_device_policy(tmp_path, monkeypatch):
    ST.save(str(tmp_path), 0, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ST.restore(str(tmp_path), 0, {"w": torch.zeros(2)})


def test_checkpoint_manager_async(tmp_path):
    """The reference's `test_checkpoint_manager_async`, on the port."""
    mgr = ST.CheckpointManager(str(tmp_path), keep=2, interval_steps=2)
    tree = {"w": torch.ones((4,))}
    for step in range(1, 7):
        mgr.maybe_save(step, tree)
    mgr.close()
    assert ST.latest_step(str(tmp_path)) == 6
    kept = [n for n in os.listdir(tmp_path) if n.startswith("step_")]
    assert len(kept) <= 2
    assert not mgr._worker.is_alive()


def test_manager_wait_returns_after_a_slow_save_committed(tmp_path,
                                                          monkeypatch):
    real = ST.save

    def slow(*a, **kw):
        time.sleep(0.4)
        return real(*a, **kw)
    monkeypatch.setattr(ST, "save", slow)
    mgr = ST.CheckpointManager(str(tmp_path), keep=3, interval_steps=1)
    assert mgr.maybe_save(4, {"w": torch.ones(3)})
    mgr.wait()
    assert ST.latest_step(str(tmp_path)) == 4        # committed, not queued
    mgr.close()
    assert not mgr._worker.is_alive()


def test_manager_drops_a_pending_save_and_snapshots_before_queuing(
        tmp_path, monkeypatch):
    """While the writer is busy, a newer save replaces the pending one;
    the tree is copied to the host when queued, so a later in-place update
    does not reach the checkpoint; a failing save raises from wait()."""
    real, gate, started = ST.save, threading.Event(), threading.Event()

    def gated(root, step, tree, extra=None):
        if step == 1:
            started.set()
            assert gate.wait(10)
        if step == 7:
            raise OSError("disk full")
        return real(root, step, tree, extra)
    monkeypatch.setattr(ST, "save", gated)
    mgr = ST.CheckpointManager(str(tmp_path), keep=5, interval_steps=1)
    w = torch.zeros(2)
    mgr.maybe_save(1, {"w": w})
    assert started.wait(10)
    w += 2
    mgr.maybe_save(2, {"w": w})                      # pending ...
    w += 1
    mgr.maybe_save(3, {"w": w})                      # ... replaced
    w += 10
    gate.set()
    mgr.wait()
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000001", "step_00000003"]
    got = ST.restore(str(tmp_path), 3, {"w": torch.zeros(2)}, device="cpu")
    assert got["w"].tolist() == [3.0, 3.0]
    mgr.maybe_save(7, {"w": w})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.close()


def test_tied_tree_crosses_between_the_packages(tmp_path):
    """gemma2-2b's tree has no `lm_head` (tied embeddings): a checkpoint of
    either package restores bit-equal in the other, in bfloat16 too."""
    arch = "gemma2-2b"
    rmodel = RR.build(RC.get(arch, reduced=True))
    module = TR.build(tget(arch, reduced=True)).init(
        torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
    tree = module.tree()
    assert "lm_head" not in tree
    struct = jax.eval_shape(lambda: rmodel.init(jax.random.key(0),
                                                jnp.bfloat16))
    ST.save(str(tmp_path / "port"), 1, tree)
    got = RST.restore(str(tmp_path / "port"), 1, struct)
    flat_got, flat_want = _flat_ref(got), _flat_port(tree)
    assert list(flat_got) == list(flat_want)
    for k, want in flat_want.items():
        assert str(flat_got[k].dtype) == "bfloat16", k
        np.testing.assert_array_equal(_bits(flat_got[k]), _bits(want),
                                      err_msg=k)
    RST.save(str(tmp_path / "ref"), 2, got)
    back = ST.restore(str(tmp_path / "ref"), 2, jax.tree_util.tree_map(
        torch.zeros_like, tree), device="cpu")
    for k, want in _flat_port(back).items():
        assert torch.equal(want, flat_want[k]), k
