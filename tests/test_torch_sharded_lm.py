"""The port's sharded LM entry points across ranks: one train step of
reduced gemma2-2b (FSDP + TP + SP) and of reduced granite-moe-1b-a400m
(the same, with the expert-parallel MoE inside the step) on a (2, 2)
("data", "model") mesh against the reference's single-device step, and
`ServeEngine(sc=)` on that mesh against the same engine without one.

The step really moves the weights (lr 1e-2, no warmup), and the
comparison holds what the backward computed, leaf by leaf: the first
moment after one step is (1 - b1) times the clipped gradient, so it is
compared at 1e-4 of each leaf's max, the gradient norm before clipping at
1e-4 relative, and each leaf's update p1 - p0 at 1e-2 of its max (an
update left out, or scaled by 0.5, is off by 1 or 0.5 of it).

Four CPU processes joined by gloo (`torch_dist.start`) run all of it once
(a module-scoped fixture), while the reference runs here under jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import registry as RR
from repro.train import optim as ROPT
from repro.train.step import TrainConfig as RTrainConfig
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import configs as TC
from repro_torch.models import registry as TR
from repro_torch.models.params import flatten_tree

import torch_dist
from torch_parity import jit, reference_tree

ARCHS = ("gemma2-2b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
         "xlstm-125m")
# Adam's first step is about sign(g) / (1 + eps / |g|): eps 1e-4 keeps a
# gradient entry near 0 from turning float32 summation-order noise into a
# step of up to 2 lr
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-4)
# the EP MoE's load-balance loss is the mean of each shard's (the
# reference's EP rule), not the single-device value: granite's step leaves
# it out of the loss, so that its gradients are the reference's.  The EP
# aux itself is held in test_torch_distributed.py
AUX_WEIGHT = {"gemma2-2b": 0.01, "granite-moe-1b-a400m": 0.0,
              "jamba-v0.1-52b": 0.0, "xlstm-125m": 0.01}


def _leaves(tree):
    return {".".join(str(getattr(q, "key", q)) for q in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(state_dict):
    out: dict = {}
    for k, v in state_dict.items():
        *parents, leaf = k.split(".")
        node = out
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = v.numpy()
    return out


def _train_input(arch):
    """The port's initial weights (a module) and the ranks' input: those
    weights and a (4, 16) batch."""
    module = TR.build(TC.get(arch, reduced=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    vocab = RC.get(arch, reduced=True).vocab_size
    rng = np.random.default_rng(0)
    b, s = 4, 16
    batch = {"tokens": rng.integers(0, vocab, (b, s)),
             "labels": rng.integers(0, vocab, (b, s)),
             "positions": np.broadcast_to(np.arange(s), (b, s)).copy()}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    return module, {"arch": arch, "params": _nested(module.state_dict()),
                    "batch": batch, "opt": OPT,
                    "aux_weight": AUX_WEIGHT[arch]}


def _reference_step(module, inp):
    """The reference's single-device step from the same weights and batch."""
    rmodel = RR.build(RC.get(inp["arch"], reduced=True))
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    tc = RTrainConfig(compute_dtype=jnp.float32, remat=True,
                      use_chunked_ce=False, aux_weight=inp["aux_weight"])
    step = jit(r_make_train_step(rmodel, tc, ROPT.AdamWConfig(**OPT)))
    p1, o1, m1 = step(rparams, ROPT.init(rparams), inp["batch"])
    return {"loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
            "p0": {k: v.numpy() for k, v in module.state_dict().items()},
            "p1": _leaves(p1), "m": _leaves(o1.m)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    modules, inputs = {}, {}
    for arch in ARCHS:
        name = f"train_step:{arch}"
        modules[name], inputs[name] = _train_input(arch)
    # the ranks run while the reference compiles here
    wait = torch_dist.start(torch_dist.run_scenarios, 4,
                            tmp_path_factory.mktemp("lm"),
                            list(inputs) + ["serve"], inputs)
    refs = {name: _reference_step(modules[name], inp)
            for name, inp in inputs.items()}
    return wait(), refs


def _results(runs, name):
    outs, refs = runs
    per_rank = [o[name] for o in outs]
    for r, o in enumerate(per_rank):
        if isinstance(o, dict) and "error" in o:
            raise AssertionError(f"{name} failed on rank {r}:\n{o['error']}")
    return per_rank, refs.get(name)


def _close_to_max(got, want, frac, name):
    """max |got - want| <= frac * max |want|, and want is not all zero."""
    top = float(np.abs(want).max())
    assert top > 0, f"{name}: the reference's value is all zero"
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= frac * top, f"{name}: {err} > {frac} * {top}"


def _check_step(runs, arch):
    per_rank, ref = _results(runs, f"train_step:{arch}")
    for o in per_rank:
        np.testing.assert_allclose(o["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(o["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)
        assert set(o["params"]) == set(o["m"]) == set(ref["p1"]) == \
            set(ref["p0"])
        for k, p0 in ref["p0"].items():
            _close_to_max(o["m"][k], ref["m"][k], 1e-4, f"m {k}")
            _close_to_max(o["params"][k] - p0, ref["p1"][k] - p0, 1e-2,
                          f"update {k}")
    return per_rank


def test_sharded_train_step_matches_reference_single_device(runs):
    """One step of gemma2 with params / opt state placed by
    params_shardings (FSDP), the batch by batch_specs and the activations
    by the shard callback (SP) == the reference's step on one device:
    loss and gradient norm within 1e-4 relative, every leaf's gradient
    (first moment) within 1e-4 and its update within 1e-2 of its max."""
    per_rank = _check_step(runs, "gemma2-2b")
    # FSDP and TP really split the weights: the query projection is
    # (fsdp over data, model) and the embedding (model over vocab, data)
    pl = per_rank[0]["placements"]
    assert pl["layers.sub0.mix.wq.w"] == "(Shard(dim=1), Shard(dim=2))"
    assert pl["embed.emb"] == "(Shard(dim=1), Shard(dim=0))"


def test_sharded_moe_train_step_matches_reference_single_device(runs):
    """The same for granite-moe, whose MoE layers run moe_apply_ep (one
    all_to_all out and one back over "model") inside the step, against
    the reference's single-device step through its sorted dispatch."""
    per_rank = _check_step(runs, "granite-moe-1b-a400m")
    for o in per_rank:
        assert o["moe_impl"] == "ep" and o["ep_calls"] > 0
    pl = per_rank[0]["placements"]
    assert pl["layers.sub0.ffn.w_in"] == "(Shard(dim=2), Shard(dim=1))"


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_sharded_recurrent_train_step_matches_reference_single_device(
        runs, arch):
    """The same for jamba (mamba mixers and an EP MoE) and xlstm (mLSTM
    and sLSTM blocks): mamba's conv and scan run on each rank's d_inner
    channels, the xLSTM cells on its batch rows (`Shard.local`)."""
    _check_step(runs, arch)


@pytest.mark.parametrize("arch", torch_dist.SERVE_ARCHS)
def test_sharded_serve_tokens_equal_unsharded(runs, arch):
    """ServeEngine(sc=) on the (2, 2) mesh (weights by params_shardings,
    KV caches and recurrent states by state_specs, granite's prefill
    through the expert-parallel MoE, jamba's and xlstm's recurrent
    states placed by state_specs too) gives the unsharded engine's greedy
    tokens at float32."""
    per_rank, _ = _results(runs, "serve")
    for o in per_rank:
        plain, sharded = o[arch]
        np.testing.assert_array_equal(sharded, plain)


def test_reference_tree_paths_are_the_ports(runs):
    """The leaves compared above are every leaf of the port's tree."""
    for arch in ARCHS:
        module = TR.build(TC.get(arch, reduced=True)).init(
            torch.Generator().manual_seed(0), device="cpu")
        _, ref = _results(runs, f"train_step:{arch}")
        assert set(ref["p1"]) == {k for k, _ in flatten_tree(module.tree())}
