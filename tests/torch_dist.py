"""Multi-rank helpers for the port's sharding tests: `spawn` runs a function
in N CPU processes joined by a gloo process group (file:// rendezvous under
a test's tmp_path), one intra-op thread each, and returns each rank's
result.  The scenario functions below run in those processes: they import
torch and the port only (never jax); a test computes the reference's side
in its own process and hands it over as numpy arrays."""

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _child(rank, fn, world, root):
    torch.set_num_threads(1)
    args = torch.load(os.path.join(root, "args.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, *args)
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()


def start(fn, world: int, root, *args):
    """Start fn(rank, *args) in `world` processes; returns a function that
    waits for them and gives [each rank's result] (the caller works on
    meanwhile, e.g. computes the reference's side)."""
    import torch.multiprocessing as mp
    root = str(root)
    os.makedirs(root, exist_ok=True)
    # the arguments go through a file: pickled into the processes' start
    # pipes, a large input blocks each start until the process before it
    # has imported torch, and the ranks start one after another
    torch.save(args, os.path.join(root, "args.pt"))
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ctx = mp.spawn(_child, args=(fn, world, root), nprocs=world,
                       join=False)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old

    def wait():
        while not ctx.join():
            pass
        outs = [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
        for r, o in enumerate(outs):
            if isinstance(o, dict) and "error" in o:
                raise AssertionError(f"rank {r} failed:\n{o['error']}")
        return outs
    return wait


def spawn(fn, world: int, root, *args):
    """[fn(rank, *args) for each rank] run in `world` processes."""
    return start(fn, world, root, *args)()


def _scenarios(rank, items):
    """Run each (name, fn, args) and record its result or its error, so
    one failing scenario does not hide the others."""
    out = {}
    for name, fn, args in items:
        try:
            out[name] = fn(rank, *args)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def run_scenarios(rank, names, inputs):
    """Each named scenario (`SCENARIOS[name]`, or the part before a ':')
    with its input `inputs.get(name)`."""
    return _scenarios(rank, [(n, SCENARIOS[n.split(":")[0]],
                              (inputs.get(n),)) for n in names])


def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, device_type="cpu")


def _tree(arrays):
    """Nested dict of numpy arrays -> float32 tensors."""
    if isinstance(arrays, dict):
        return {k: _tree(v) for k, v in arrays.items()}
    return torch.from_numpy(np.asarray(arrays))


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def ep_moe(rank, inp):
    """moe_apply_ep on a (1, 4) mesh: the output (global) and, against
    the port's dense MoE (one process, autograd), the largest gradient
    difference over x and each weight, relative to the leaf's max."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as MOE
    cfg = configs.get(inp["arch"], reduced=True).replace(**inp["cfg"])
    mesh = _mesh((1, 4), ("data", "model"))
    p = _tree(inp["params"])
    x = torch.from_numpy(inp["x"])
    out, aux = MOE.moe_apply_ep(p, cfg, x, mesh=mesh,
                                capacity_factor=32.0)
    # gradients of a fixed projection of the output (no aux term)
    r = torch.from_numpy(np.random.default_rng(7).normal(
        size=x.shape).astype(np.float32))
    leaves = {"x": x, "w_in": p["w_in"], "w_out": p["w_out"],
              "router": p["router"]["w"]}
    if "w_gate" in p:
        leaves["w_gate"] = p["w_gate"]

    def grads(fn):
        live = {k: v.detach().clone().requires_grad_() for k, v in
                leaves.items()}
        q = {"router": {"w": live["router"]}, "w_in": live["w_in"],
             "w_out": live["w_out"]}
        if "w_gate" in live:
            q["w_gate"] = live["w_gate"]
        y = fn(q, live["x"])
        (SH.full((y * SH.like(r, y)).sum())).backward()
        return {k: SH.full(v.grad) for k, v in live.items()}
    g_ep = grads(lambda q, xx: MOE.moe_apply_ep(
        q, cfg, xx, mesh=mesh, capacity_factor=32.0)[0])
    g_dense = grads(lambda q, xx: MOE.moe_apply_dense(q, cfg, xx)[0])
    rel = {k: float((g_ep[k] - g_dense[k]).abs().max()
                    / g_dense[k].abs().max()) for k in g_ep}
    return {"out": SH.full(out).detach().numpy(), "aux": float(SH.full(aux)),
            "grad_rel": rel}


def pipeline(rank, inp):
    """pipelined_forward over pod = 2 on a (2, 2, 1) mesh: the output and
    the gradient of sum(out ** 2) over all bodies' weights."""
    from repro_torch.distributed import pipeline as PP
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    w = torch.from_numpy(inp["w"]).requires_grad_()
    x = torch.from_numpy(inp["x"])

    def body_fn(p, h):
        return torch.tanh(h @ p["w"])
    out = PP.pipelined_forward(body_fn, {"w": w}, x, mesh, n_micro=4)
    (out ** 2).sum().backward()
    g = w.grad.clone()
    dist.all_reduce(g, group=mesh.get_group("pod"))   # stages' slices
    return {"out": out.detach().numpy(), "grad": g.numpy()}


def compressed(rank, inp):
    """20 rounds of compressed_psum over pod = 2 on a (2, 2, 1) mesh: each
    round's exchanged mean (both pods' must be identical) and the running
    sums' drift from the exact means."""
    from repro_torch.distributed import compression as C
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    group = mesh.get_group("pod")
    pod = dist.get_rank(group)
    rng = np.random.default_rng(0)
    err = torch.zeros((1, 300), dtype=torch.float32)
    true_sum = np.zeros((1, 300), np.float32)
    got_sum = np.zeros((1, 300), np.float32)
    same = True
    for _ in range(20):
        x = rng.normal(size=(2, 1, 300)).astype(np.float32)
        mean, err = C.compressed_psum(torch.from_numpy(x[pod]), group, err)
        both = [torch.empty_like(mean) for _ in range(2)]
        dist.all_gather(both, mean, group=group)
        same &= bool(torch.equal(both[0], both[1]))
        true_sum += x.mean(axis=0)
        got_sum += mean.numpy()
    drift = float(np.abs(got_sum - true_sum).mean()
                  / np.abs(true_sum).mean())
    return {"same": same, "drift": drift}


def hierarchical(rank, inp):
    """hierarchical_grads on a (2, 2, 1) mesh against the exact gradient of
    the whole batch, relative to its max; and the grads unchanged on a
    mesh with no pod axis."""
    from repro_torch.distributed import compression as C
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    batch = {"x": torch.from_numpy(rng.normal(size=(16, 8))
                                   .astype(np.float32)),
             "y": torch.from_numpy(rng.normal(size=(16, 4))
                                   .astype(np.float32))}

    def grad_fn(w, b):
        w = w.detach().requires_grad_()
        loss = ((b["x"] @ w - b["y"]) ** 2).mean()
        loss.backward()
        return w.grad, {"loss": loss.detach()}
    exact, _ = grad_fn(w, batch)
    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    err = C.init_error_buffers(w)
    got, err2, metrics = C.hierarchical_grads(grad_fn, mesh, w, batch, err)
    flat = _mesh((4, 1), ("data", "model"))
    same, err3, _ = C.hierarchical_grads(grad_fn, flat, w, batch, err)
    return {"rel": float((got - exact).abs().max() / exact.abs().max()),
            "no_pod_equal": bool(torch.equal(same, exact)) and err3 is err,
            "err_shape": tuple(err2.shape)}


def train_step(rank, inp):
    """One sharded train step of a reduced arch on a (2, 2) mesh with FSDP
    and SP, from the given weights and batch: loss, gradient norm, the
    updated parameters and first moments (gathered), the placements, the
    MoE implementation the step picks and how often it ran moe_apply_ep."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.models import registry
    from repro_torch.train import optim as OPT
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = configs.get(inp["arch"], reduced=True)
    model = registry.build(cfg)
    params = _tree(inp["params"])
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    tc = TrainConfig(compute_dtype=torch.float32, remat=True,
                     use_chunked_ce=False, aux_weight=inp["aux_weight"])
    mesh = _mesh((2, 2), ("data", "model"))
    sc = SH.ShardingConfig(mesh, fsdp=True, seq_parallel=True)
    calls = [0]
    ep = MOE.moe_apply_ep

    def counted(*a, **k):
        calls[0] += 1
        return ep(*a, **k)
    MOE.moe_apply_ep = counted
    try:
        step = make_train_step(model, tc, OPT.AdamWConfig(**inp["opt"]), sc)
        p2, o2, m2 = step(params, OPT.init(params), batch)
    finally:
        MOE.moe_apply_ep = ep
    placements = {k: str(v.placements) for k, v in
                  _flat(p2).items()}
    return {"loss": float(m2["loss"]), "grad_norm": float(m2["grad_norm"]),
            "params": {k: v.numpy() for k, v in _flat(SH.gather(p2)).items()},
            "m": {k: v.numpy() for k, v in _flat(SH.gather(o2.m)).items()},
            "placements": placements,
            "moe_impl": registry.default_moe_impl(cfg, "train", mesh),
            "ep_calls": calls[0]}


def _flat(tree):
    from repro_torch.models.params import flatten_tree
    return dict(flatten_tree(tree))


def serve(rank, inp):
    """Greedy tokens of reduced gemma2-2b and granite-moe (whose prefill
    takes the expert-parallel MoE) from ServeEngine on a (2, 2) mesh and
    without one, from the same weights."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import registry
    from repro_torch.serve.lm import ServeConfig, ServeEngine
    svc = ServeConfig(max_len=32, cache_dtype=torch.float32,
                      compute_dtype=torch.float32)
    sc = SH.ShardingConfig(_mesh((2, 2), ("data", "model")),
                           seq_parallel=True)
    out = {}
    for arch in ("gemma2-2b", "granite-moe-1b-a400m"):
        cfg = configs.get(arch, reduced=True)
        model = registry.build(cfg)
        params = model.init(torch.Generator().manual_seed(0),
                            device="cpu").tree()
        # the train step's (4, 16) rows: the prefill meets DTensor's
        # sharding-propagation caches warm
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                    (4, 16))
        plain = ServeEngine(model, params, svc, device="cpu").generate(
            prompts, 4)
        sharded = ServeEngine(model, params, svc, device="cpu",
                              sc=sc).generate(prompts, 4)
        out[arch] = (plain, sharded)
    return out


def elastic(rank, inp):
    """resume_or_init / save_state across meshes on 8 ranks: a fresh start
    on (2, 4); a save there; a resume on (4, 2) (params and moments
    bit-equal to the saved ones, the start step, the new placements); a
    fresh optimizer state when `opt` lags; the divisibility check."""
    import shutil

    from repro_torch import configs
    from repro_torch.checkpoint import elastic as EL
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import registry
    from repro_torch.train import optim as OPT
    root = inp["root"]
    model = registry.build(configs.get("qwen1.5-4b", reduced=True))

    def init():
        return model.init(torch.Generator().manual_seed(0), device="cpu")
    out = {}
    sc_a = SH.ShardingConfig(_mesh((2, 4), ("data", "model")), fsdp=True)
    p, o, step = EL.resume_or_init(root, init, sc_a, 8)
    out["fresh_step"] = step
    out["fresh_equal"] = all(torch.equal(a, b) for a, b in zip(
        _flat(SH.gather(p)).values(), _flat(init().tree()).values()))
    # a nonzero state to save: one update's worth of moments
    o = OPT.OptState(o.step + 3, _add(o.m, 0.5), _add(o.v, 0.25))
    EL.save_state(root, 3, p, o)
    sc_b = SH.ShardingConfig(_mesh((4, 2), ("data", "model")), fsdp=True)
    p2, o2, step2 = EL.resume_or_init(root, init, sc_b, 8)
    out["resume_step"] = step2
    out["params_equal"] = all(torch.equal(a, b) for a, b in zip(
        _flat(SH.gather(p2)).values(), _flat(SH.gather(p)).values()))
    out["m_equal"] = all(torch.equal(a, b) for a, b in zip(
        _flat(SH.gather(o2.m)).values(), _flat(SH.gather(o.m)).values()))
    out["opt_step"] = int(o2.step)
    out["wq_placements"] = str(_flat(p2)["layers.sub0.mix.wq.w"].placements)
    if rank == 0:
        shutil.rmtree(os.path.join(root, "opt", "step_00000003"))
    dist.barrier()
    _, o3, step3 = EL.resume_or_init(root, init, sc_b, 8)
    out["lagging_opt"] = (step3, int(o3.step), float(sum(
        SH.full(v).abs().sum() for v in _flat(o3.m).values())))
    try:
        EL.resume_or_init(root, init, sc_b, 6)
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    return out


def _add(tree, c):
    from repro_torch.models.params import tree_map
    return tree_map(lambda x: x + c, tree)


def launcher(rank, inp):
    """launch.train.main --mesh debug on 8 ranks: 2 steps saving every 2,
    then a resumed run to step 3; the losses of both."""
    from repro_torch.launch import train as TRAIN
    args = inp["args"] + ["--mesh", "debug", "--device", "cpu",
                          "--ckpt-dir", inp["root"], "--ckpt-every", "2"]
    first = TRAIN.main(args + ["--steps", "2"])
    resumed = TRAIN.main(args + ["--steps", "3"])
    return {"first": first, "resumed": resumed}


SCENARIOS = {"elastic": elastic, "launcher": launcher, "ep_moe": ep_moe,
             "pipeline": pipeline, "compressed": compressed,
             "hierarchical": hierarchical, "train_step": train_step,
             "serve": serve}
