"""Training launcher on one card: config -> model -> train loop with
fault tolerance (checkpoint/restart, preemption, heartbeat, stragglers) —
the port of the reference's `launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/run1 \
        [--device cpu]

It takes the reference's flags, with their defaults and meanings, plus
`--device` (default: the card; `cpu` runs the plain PyTorch versions).
`--compute-dtype` names a torch dtype; `--moe-impl` is parsed and unused,
as in the reference.  It prints the reference's `step ... loss ... gnorm
... lr ... s` lines and closing `loss a -> b (improved|NOT improved)` line,
and resumes from the newest committed checkpoint under `--ckpt-dir`
(params, then `<ckpt-dir>/opt`), whichever package wrote it.

`--mesh debug|pod|multipod` trains sharded (`distributed/sharding.py`) on
the reference's mesh (`launch/mesh.py`), one process a device:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen1.5-4b --reduced --mesh debug [--device cpu]

The process group comes from torchrun's environment (NCCL on the card,
gloo with `--device cpu`) unless the caller has initialised one; a world
size other than the mesh's product raises ValueError.  FSDP is on
above 3e9 parameters; with `--ckpt-dir` the run starts through
`checkpoint.elastic.resume_or_init` (any mesh's checkpoint resumes on any
other) and saves through `elastic.save_state`.  Rank 0 prints.

One difference from the reference: its loop stops the step timer as soon
as the step is dispatched; here the step's metrics are read (which waits
for its device work) before the timer stops, so a step's `s` and the
straggler flag are the step's real time on the card.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None, *, on_step=None):
    """Run the launcher; returns the losses of the steps it ran.
    `on_step(step, metrics, stats)`, if given, is called after each step
    with its metrics as floats and its StepTimer record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-total-steps", type=int, default=None,
                    help="schedule horizon (defaults to --steps); set it "
                         "explicitly when a run will be resumed so the "
                         "schedule is invariant to segmentation")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "debug", "pod", "multipod"],
                    default="none")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs, nn
    from repro_torch.checkpoint import elastic, store
    from repro_torch.device import resolve_device
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.models import registry
    from repro_torch.train import optim as OPT
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        place_train_state)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=args.reduced)
    model = registry.build(cfg)
    tc = TrainConfig(compute_dtype=getattr(torch, args.compute_dtype),
                     remat=True, accum_steps=args.accum,
                     use_chunked_ce=cfg.vocab_size >= 8192)
    horizon = args.lr_total_steps or args.steps
    ocfg = OPT.AdamWConfig(lr=args.lr, total_steps=horizon,
                           warmup_steps=max(1, horizon // 20))

    # ---- init or resume ---------------------------------------------------
    own_group = args.mesh != "none" and _init_process_group(dev)
    try:
        start_step, sc = 0, None
        params = model.init(
            torch.Generator(device=dev).manual_seed(args.seed), device=dev)
        if args.mesh != "none":
            mesh = {"debug": make_debug_mesh, "pod": make_production_mesh,
                    "multipod": lambda **kw: make_production_mesh(
                        multi_pod=True, **kw)}[args.mesh](
                            device_type=dev.type)
            sc = SH.ShardingConfig(mesh, fsdp=nn.count_params(params) > 3e9,
                                   seq_parallel=True)
        rank0 = sc is None or torch.distributed.get_rank() == 0
        step_fn = make_train_step(model, tc, ocfg, sc)
        if sc is not None and args.ckpt_dir:
            params, opt_state, start_step = elastic.resume_or_init(
                args.ckpt_dir, lambda: params, sc, args.batch)
            if start_step and rank0:
                print(f"[resume] step {start_step}", flush=True)
        elif sc is not None:
            params, opt_state = place_train_state(params, OPT.init(params),
                                                  sc)
        else:
            opt_state = OPT.init(params)
            if args.ckpt_dir:
                last = store.latest_step(args.ckpt_dir)
                if last is not None:
                    params = store.restore(args.ckpt_dir, last, params,
                                           device=dev)
                    opt_state = store.restore(args.ckpt_dir + "/opt", last,
                                              opt_state, device=dev)
                    start_step = last
                    print(f"[resume] step {last}", flush=True)
        # handed over in a dict the loop empties, so that no frame keeps
        # the first trees alive once a step has returned new ones
        state = {"params": params, "opt_state": opt_state}
        del params, opt_state
        return _loop(args, cfg, step_fn, state, start_step, sc, rank0,
                     on_step)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _init_process_group(dev) -> bool:
    """The default process group from torchrun's environment (NCCL on the
    card, gloo on the CPU) when none is initialised and the environment
    names a rendezvous; True when this call created it."""
    import os

    import torch
    import torch.distributed as dist
    if dist.is_initialized() or "MASTER_ADDR" not in os.environ:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return True


def _loop(args, cfg, step_fn, state, start_step, sc, rank0, on_step):
    from repro_torch.checkpoint import elastic, store
    from repro_torch.data.pipeline import PrefetchIterator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.fault_tolerance import (Heartbeat,
                                                    PreemptionHandler,
                                                    StepTimer)

    params, opt_state = state.pop("params"), state.pop("opt_state")

    def save(step):
        if sc is not None:
            elastic.save_state(args.ckpt_dir, step, params, opt_state)
        else:
            store.save(args.ckpt_dir, step, params)
            store.save(args.ckpt_dir + "/opt", step, opt_state)

    def batch_fn(step):
        return token_batch(args.seed, step, args.batch, args.seq,
                           cfg.vocab_size)

    data = PrefetchIterator(batch_fn, start_step=start_step)
    timer = StepTimer()
    hb = Heartbeat(stall_s=1800)
    losses = []
    try:
        with PreemptionHandler() as pre:
            for step, batch in data:
                if step >= args.steps or pre.should_stop:
                    break
                timer.start()
                # the old trees go as soon as the step returns the new ones
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                stats = timer.stop()
                hb.beat()
                losses.append(metrics["loss"])
                if on_step is not None:
                    on_step(step, metrics, stats)
                if rank0 and (step % args.log_every == 0
                              or stats["straggler"]):
                    print(f"step {step:5d} loss {metrics['loss']:.4f} "
                          f"gnorm {metrics['grad_norm']:.3f} "
                          f"lr {metrics['lr']:.2e} "
                          f"{stats['step_s']:.2f}s"
                          + (" [straggler]" if stats["straggler"] else ""),
                          flush=True)
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    save(step + 1)

            if pre.should_stop and args.ckpt_dir:
                print("[preempt] saving final checkpoint", flush=True)
                save(step)
    finally:
        data.close()
        hb.close()
    if len(losses) >= 10 and rank0:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
