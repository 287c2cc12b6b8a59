"""Training launcher on one card: config -> model -> train loop with
fault tolerance (checkpoint/restart, preemption, heartbeat, stragglers) —
the port of the reference's `launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/run1 \
        [--device cpu]

It takes the reference's flags, with their defaults and meanings, plus
`--device` (default: the card; `cpu` runs the plain PyTorch versions).
`--compute-dtype` names a torch dtype; `--moe-impl` is parsed and unused,
as in the reference; a `--mesh` other than `none` raises (ROADMAP.md
Queue A item 6).  It prints the reference's `step ... loss ... gnorm ...
lr ... s` lines and closing `loss a -> b (improved|NOT improved)` line, and
resumes from the newest committed checkpoint under `--ckpt-dir` (params,
then `<ckpt-dir>/opt`), whichever package wrote it.

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

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import PrefetchIterator
    from repro_torch.data.synthetic import token_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.fault_tolerance import (Heartbeat,
                                                    PreemptionHandler,
                                                    StepTimer)
    from repro_torch.models import registry
    from repro_torch.train import optim as OPT
    from repro_torch.train.step import TrainConfig, make_train_step

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported yet "
            "(ROADMAP.md Queue A item 6); the port trains on one card "
            "(--mesh none)")
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, reduced=args.reduced)
    model = registry.build(cfg)

    tc = TrainConfig(compute_dtype=getattr(torch, args.compute_dtype),
                     remat=True, accum_steps=args.accum,
                     use_chunked_ce=cfg.vocab_size >= 8192)
    horizon = args.lr_total_steps or args.steps
    ocfg = OPT.AdamWConfig(lr=args.lr, total_steps=horizon,
                           warmup_steps=max(1, horizon // 20))
    step_fn = make_train_step(model, tc, ocfg)

    # ---- init or resume ---------------------------------------------------
    start_step = 0
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    opt_state = OPT.init(params)
    if args.ckpt_dir:
        last = store.latest_step(args.ckpt_dir)
        if last is not None:
            params = store.restore(args.ckpt_dir, last, params, device=dev)
            opt_state = store.restore(args.ckpt_dir + "/opt", last,
                                      opt_state, device=dev)
            start_step = last
            print(f"[resume] step {last}", flush=True)

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
                if step % args.log_every == 0 or stats["straggler"]:
                    print(f"step {step:5d} loss {metrics['loss']:.4f} "
                          f"gnorm {metrics['grad_norm']:.3f} "
                          f"lr {metrics['lr']:.2e} "
                          f"{stats['step_s']:.2f}s"
                          + (" [straggler]" if stats["straggler"] else ""),
                          flush=True)
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    store.save(args.ckpt_dir, step + 1, params)
                    store.save(args.ckpt_dir + "/opt", step + 1, opt_state)

            if pre.should_stop and args.ckpt_dir:
                print("[preempt] saving final checkpoint", flush=True)
                store.save(args.ckpt_dir, step, params)
                store.save(args.ckpt_dir + "/opt", step, opt_state)
    finally:
        data.close()
        hb.close()
    if len(losses) >= 10:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
