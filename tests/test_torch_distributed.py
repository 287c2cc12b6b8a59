"""The port's expert-parallel MoE, GPipe pipeline and compressed cross-pod
gradients across ranks, against the reference's single-device results.

Four CPU processes joined by gloo (`torch_dist.spawn`, file:// rendezvous
under tmp_path, one thread each) run every scenario once (a module-scoped
fixture); the reference's side runs here under jax on the CPU.  The
reference's own multi-device versions of these tests fail under this jax
(tests/test_distributed.py), so the port is held to the reference's
single-device functions: `moe_apply_sorted` and a sequential scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as RC
from repro.models import moe as RMOE

import torch_dist
from torch_parity import jit

EP_CASES = {
    # ep = 4 over E = 8 experts (2 a shard), reduced granite (top 4)
    "ep_moe:e8": ("granite-moe-1b-a400m", {}, (8, 16), 0),
    # ep = 4 > E = 2: each expert replicated r = 2 times
    "ep_moe:e2": ("mixtral-8x7b", {"n_experts": 2, "topk": 2}, (4, 8), 1),
}


def _ep_input(name):
    arch, repl, (b, s), seed = EP_CASES[name]
    cfg = RC.get(arch, reduced=True).replace(**repl)
    rng = np.random.default_rng(seed)
    # the reference's parameter shapes, seeded values
    params = jax.tree_util.tree_map(
        lambda a: (rng.uniform(-1, 1, a.shape) / np.sqrt(a.shape[-2]))
        .astype(np.float32),
        jax.eval_shape(lambda: RMOE.moe_init(jax.random.key(0), cfg)))
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    ref, aux = jit(lambda p, x: RMOE.moe_apply_sorted(
        p, cfg, x, capacity_factor=32.0))(params, x)
    return {"arch": arch, "cfg": repl, "params": params, "x": x}, \
        (np.asarray(ref), float(aux))


def _pipeline_input():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.normal(size=(8, 4, 16)).astype(np.float32)

    def seq(w, x):
        y, _ = jax.lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None), x, w)
        return y
    ref = jit(seq)(w, x)
    gref = jit(jax.grad(lambda w, x: jnp.sum(seq(w, x) ** 2)))(w, x)
    return {"w": w, "x": x}, (np.asarray(ref), np.asarray(gref))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs, refs = {}, {}
    for name in EP_CASES:
        inputs[name], refs[name] = _ep_input(name)
    inputs["pipeline"], refs["pipeline"] = _pipeline_input()
    names = list(EP_CASES) + ["pipeline", "compressed", "hierarchical"]
    outs = torch_dist.spawn(torch_dist.run_scenarios, 4,
                            tmp_path_factory.mktemp("dist"), names, inputs)
    return outs, refs


def _results(runs, name):
    outs, refs = runs
    per_rank = [o[name] for o in outs]
    for r, o in enumerate(per_rank):
        if isinstance(o, dict) and "error" in o:
            raise AssertionError(f"{name} failed on rank {r}:\n{o['error']}")
    return per_rank, refs.get(name)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_moe_ep_matches_reference_sorted(runs, name):
    """The expert-parallel MoE (one all_to_all out and one back over the
    model axis) equals the reference's local sorted dispatch at ample
    capacity, on every rank; its gradients equal the port's dense MoE's."""
    per_rank, (ref, aux_ref) = _results(runs, name)
    for o in per_rank:
        np.testing.assert_allclose(o["out"], ref, rtol=2e-3, atol=2e-3)
        # aux is meaned per shard in EP vs global in the local path
        np.testing.assert_allclose(o["aux"], aux_ref, rtol=5e-2)
        for leaf, rel in o["grad_rel"].items():
            assert rel < 1e-4, (leaf, rel)


def test_pipeline_matches_sequential(runs):
    """2-stage GPipe over 'pod' == the reference's scan over all bodies,
    forward and gradient, on every rank."""
    per_rank, (ref, gref) = _results(runs, "pipeline")
    for o in per_rank:
        np.testing.assert_allclose(o["out"], ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["grad"], gref, rtol=1e-3, atol=1e-3)


def test_compressed_psum_error_feedback(runs):
    """int8 cross-pod mean: both pods hold the identical exchanged mean
    every round; error feedback keeps the running sum within 2%."""
    per_rank, _ = _results(runs, "compressed")
    for o in per_rank:
        assert o["same"]
        assert o["drift"] < 0.02, o["drift"]


def test_hierarchical_grads_compression(runs):
    """Per-pod gradients + compressed exchange == the exact gradient of
    the whole batch up to int8 noise; without a pod axis the gradients
    come back exact and the error buffers unchanged."""
    per_rank, _ = _results(runs, "hierarchical")
    for o in per_rank:
        assert o["rel"] < 0.02, o["rel"]
        assert o["no_pod_equal"]
        assert o["err_shape"] == (8, 4)
