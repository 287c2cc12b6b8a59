"""Port parity of the training launcher on the CPU: the data pipeline
(`repro_torch/data/pipeline.py`), `PreemptionHandler` / `StepTimer`
(`launch/fault_tolerance.py`), the FLOP model (`launch/flops.py`,
`launch/shapes.py`) and `launch/train.py main(... --device cpu)`.

Mirrors tests/test_launcher.py and the pipeline / preemption tests of
tests/test_train.py.  The straggler test drives StepTimer through a fake
clock (the reference's sleep-based twin is timing dependent).  The
launcher is held against the reference's `repro.launch.train.main` through
one checkpoint: the port writes step 0 of its initial weights, both
launchers resume from it on reduced qwen1.5-4b (float32, 4 x 32 tokens,
lr 1e-3 over a fixed 8-step schedule), and their printed losses agree
within 1e-4 relative at the first resumed step and 2e-3 after it (the
reference's own rule for a resumed run); then the port resumes from the
step the reference wrote.  Losses are read from the printed step lines
with the reference test's `parse_losses`.  Gradient accumulation is held
to the reference's at equal weights."""

import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data.pipeline import PrefetchIterator as RPrefetch
from repro.data.synthetic import token_batch as r_token_batch
from repro.launch import flops as RFL
from repro.launch import shapes as RSH
from repro.launch import train as RTRAIN
from repro.models import registry as RR
from repro.train import optim as ROPT
from repro.train import step as RSTEP
from repro_torch import configs as TC
from repro_torch.checkpoint import store as ST
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.data.synthetic import token_batch
from repro_torch.launch import fault_tolerance as FT
from repro_torch.launch import flops as FL
from repro_torch.launch import shapes as SH
from repro_torch.launch import train as TRAIN
from repro_torch.models import registry as TR
from repro_torch.train import optim as OPT
from repro_torch.train import step as STEP
from tests.test_launcher import parse_losses
from tests.test_torch_serve_faults import one_torch_thread  # noqa: F401
from tests.torch_parity import jit, reference_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def _bf(step):
    return token_batch(0, step, 2, 8, 100)


def test_data_pipeline_deterministic_skip_ahead_matches_reference():
    it1, rit = PrefetchIterator(_bf, start_step=0), RPrefetch(
        lambda s: r_token_batch(0, s, 2, 8, 100), start_step=0)
    seq1, rseq = [next(it1) for _ in range(5)], [next(rit) for _ in range(5)]
    it1.close()
    rit.close()
    for (s, b), (rs, rb) in zip(seq1, rseq):
        assert s == rs
        for k in rb:
            np.testing.assert_array_equal(b[k], rb[k])
    it2 = PrefetchIterator(_bf, start_step=3)      # skip-ahead restart
    s, b = next(it2)
    it2.close()
    assert s == 3
    np.testing.assert_array_equal(b["tokens"], seq1[3][1]["tokens"])
    assert not it1._t.is_alive() and not it2._t.is_alive()


def test_data_pipeline_device_and_errors():
    it = PrefetchIterator(_bf, start_step=1, device="cpu")
    s, b = next(it)
    it.close()
    assert s == 1 and all(isinstance(v, torch.Tensor) for v in b.values())
    for k, v in _bf(1).items():
        np.testing.assert_array_equal(b[k].numpy(), v)
    assert not it._t.is_alive()

    def broken(step):
        if step == 2:
            raise RuntimeError("no batch 2")
        return _bf(step)
    it = PrefetchIterator(broken)
    assert [next(it)[0] for _ in range(2)] == [0, 1]
    with pytest.raises(RuntimeError, match="no batch 2"):
        next(it)
    it.close()
    assert not it._t.is_alive()


# ---------------------------------------------------------------------------
# preemption and step timing
# ---------------------------------------------------------------------------

def test_preemption_handler_catches_sigterm_and_restores():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with FT.PreemptionHandler() as p:
            assert not p.should_stop
            os.kill(os.getpid(), signal.SIGTERM)
            assert p.should_stop          # caught, not fatal
        assert not seen                   # ... and not leaked through
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]   # original handler restored
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_preemption_handler_custom_signals():
    with FT.PreemptionHandler(signals=(signal.SIGUSR1,)) as p:
        assert not p.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert p.should_stop


def test_step_timer_flags_stragglers_on_a_fake_clock(monkeypatch):
    """The reference's straggler rules with every step time exact: no flag
    before 5 samples, a step over 2 x the median flagged, a window of 10."""
    clock = [0.0]
    monkeypatch.setattr(FT, "_now", lambda: clock[0])
    t = FT.StepTimer(window=10, straggler_factor=2.0)

    def step(dt):
        clock[0] = 0.0
        t.start()
        clock[0] = dt
        return t.stop()
    first = step(0.5)
    assert first == {"step_s": 0.5, "median_s": 0.5, "straggler": False}
    assert not any(step(0.01)["straggler"] for _ in range(3))
    assert not step(1.0)["straggler"]     # 4 samples: too few to flag
    assert not step(0.01)["straggler"]
    slow = step(0.03)                     # 6 samples, median 0.01
    assert slow["straggler"] and slow["median_s"] == 0.01
    assert not step(0.02)["straggler"]    # exactly 2 x: not over
    assert not step(0.01)["straggler"]    # recovery
    for _ in range(10):
        step(1.0)                         # the window forgets the fast steps
    assert len(t.times) == 10 and not step(1.5)["straggler"]


# ---------------------------------------------------------------------------
# FLOP model
# ---------------------------------------------------------------------------

def test_shapes_match_reference():
    assert SH.SHAPES == {k: SH.ShapeSpec(*(getattr(v, f) for f in (
        "name", "kind", "seq", "batch"))) for k, v in RSH.SHAPES.items()}
    assert (SH.VLM_PATCH_TOKENS, SH.AUDIO_DEC_FRACTION) == \
        (RSH.VLM_PATCH_TOKENS, RSH.AUDIO_DEC_FRACTION)


@pytest.mark.parametrize("reduced", [False, True])
def test_flop_model_equals_reference(reduced):
    archs = sorted(set(TC.list_archs()) & set(RC.list_archs()))
    assert len(archs) == 12
    cells = 0
    for name in archs:
        cfg, rcfg = TC.get(name, reduced=reduced), RC.get(name,
                                                          reduced=reduced)
        for key, shape in SH.SHAPES.items():
            rshape = RSH.SHAPES[key]
            why = SH.cell_supported(cfg, shape)
            assert why == RSH.cell_supported(rcfg, rshape)
            if why is not None:
                continue
            for remat in (True, False):
                assert FL.cell_flops(cfg, shape, remat) == \
                    RFL.cell_flops(rcfg, rshape, remat)
            cells += 1
        if cfg.family != "pointcloud":
            for sq, kv in ((1, 4096), (512, 512), (4096, 4096), (7, 5000)):
                for head in (True, False):
                    assert FL.forward_flops(cfg, sq, kv, head) == \
                        RFL.forward_flops(rcfg, sq, kv, head)
    # ten LM archs (qwen2-vl's patch tokens and seamless's encoder among
    # them) run three shapes; mixtral, jamba, xlstm and gemma2
    # (subquadratic) also run long_500k
    assert cells == 10 * 3 + 4


def test_flops_of_the_smoke_train_step():
    """chip_smoke's phase 13 divides this by the step time: granite-moe at
    4 x 512 with remat, 7.23 TFLOP a step."""
    cfg = TC.get("granite-moe-1b-a400m")
    got = FL.cell_flops(cfg, SH.ShapeSpec("smoke", "train", 512, 4))
    assert got == RFL.cell_flops(RC.get("granite-moe-1b-a400m"),
                                 RSH.ShapeSpec("smoke", "train", 512, 4))
    assert got["total"] == 4 * got["forward"]
    assert round(got["total"] / 1e12, 2) == 7.23


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

COMMON = ["--batch", "4", "--seq", "32", "--lr", "1e-3", "--log-every", "1",
          "--lr-total-steps", "8"]


def _port_main(capsys, args):
    losses = TRAIN.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert [round(x, 4) for x in losses] == [
        v for _, v in sorted(parse_losses(out).items())]
    return out


def test_train_restart_continuity(capsys, tmp_path):
    """8 steps uninterrupted, against 4 steps with checkpoints and a resume
    to 8 from the newest committed one."""
    common = ["--arch", "granite-moe-1b-a400m", "--reduced"] + COMMON
    full = parse_losses(_port_main(capsys, common + ["--steps", "8"]))
    ck = str(tmp_path / "a")
    first = _port_main(capsys, common + ["--steps", "4", "--ckpt-dir", ck,
                                         "--ckpt-every", "2"])
    assert "[resume]" not in first
    assert ST.latest_step(ck) == ST.latest_step(ck + "/opt") == 4
    resumed = _port_main(capsys, common + ["--steps", "8", "--ckpt-dir", ck,
                                           "--ckpt-every", "2"])
    assert "[resume] step 4" in resumed
    res = parse_losses(resumed)
    assert sorted(res) == [4, 5, 6, 7]
    for s in res:
        np.testing.assert_allclose(res[s], full[s], rtol=2e-3, atol=2e-3)
    assert ST.latest_step(ck) == 8


def test_main_frees_the_initial_trees_after_a_step(monkeypatch):
    """The launcher holds no reference to the initial parameters once a
    step has returned new ones (the card holds one tree, not two: a
    trainer that kept it ran out of memory on gemma2-2b)."""
    import gc
    import weakref

    from repro_torch.models import lm as TLM
    made, real = [], TLM.lm_init

    def spy(*a, **k):
        tree = real(*a, **k)
        made.append(weakref.ref(tree))
        return tree
    monkeypatch.setattr(TLM, "lm_init", spy)
    alive = []

    def on_step(step, metrics, stats):
        gc.collect()
        alive.append(made[0]() is not None)
    TRAIN.main(["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu",
                "--steps", "2", "--batch", "2", "--seq", "16"],
               on_step=on_step)
    assert alive == [False, False]


def test_train_flags_and_device_policy(capsys, monkeypatch, tmp_path):
    # a mesh needs a process group of its size: none (no torchrun
    # environment) raises, and so does a world of one under the (2, 4) mesh
    mesh_run = ["--arch", "qwen1.5-4b", "--reduced", "--mesh", "debug",
                "--device", "cpu"]
    with pytest.raises(RuntimeError, match="initialised process group"):
        TRAIN.main(mesh_run)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1)
    try:
        with pytest.raises(ValueError, match="8 devices but the process "
                                             "group has world size 1"):
            TRAIN.main(mesh_run)
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        TRAIN.main(["--arch", "no-such-arch", "--reduced", "--device", "cpu"])
    # seamless's batches need frame embeddings, which `token_batch` does
    # not make: the reference's trainer raises KeyError, and so does the
    # port's (qwen2-vl trains on 2-D positions: tests/test_torch_qwen2vl.py)
    for main in (RTRAIN.main, TRAIN.main):
        with pytest.raises(KeyError, match="frame_embeds"):
            main(["--arch", "seamless-m4t-medium", "--reduced", "--steps",
                  "1", "--batch", "2", "--seq", "8"]
                 + (["--device", "cpu"] if main is TRAIN.main else []))
    with pytest.raises(SystemExit):
        TRAIN.main(["--arch", "qwen1.5-4b", "--mesh", "tpu"])
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TRAIN.main(["--arch", "qwen1.5-4b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TRAIN.main(["--arch", "qwen1.5-4b", "--reduced", "--steps", "1",
                    "--mesh", "debug"])
    # --accum 2, --moe-impl (parsed, unused) and bfloat16 on the CPU; no
    # closing line below 10 steps
    out = _port_main(capsys, ["--arch", "granite-moe-1b-a400m", "--reduced",
                              "--steps", "2", "--accum", "2",
                              "--moe-impl", "dense", "--compute-dtype",
                              "bfloat16"] + COMMON)
    assert sorted(parse_losses(out)) == [0, 1] and "improved" not in out


def test_preempted_launcher_saves_the_next_step(capsys, monkeypatch,
                                                tmp_path):
    """A preemption lands during step 1: the loop stops before step 2 and
    saves step 2, which a resumed run continues from."""
    real = FT.StepTimer.stop

    def stop(self):
        rec = real(self)
        if len(self.times) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return rec
    monkeypatch.setattr(FT.StepTimer, "stop", stop)
    ck = str(tmp_path / "p")
    args = ["--arch", "qwen1.5-4b", "--reduced", "--steps", "6",
            "--ckpt-dir", ck] + COMMON
    out = _port_main(capsys, args)
    assert "[preempt] saving final checkpoint" in out
    assert sorted(parse_losses(out)) == [0, 1]
    assert ST.latest_step(ck) == ST.latest_step(ck + "/opt") == 2
    monkeypatch.setattr(FT.StepTimer, "stop", real)
    out = _port_main(capsys, args)
    assert "[resume] step 2" in out and sorted(parse_losses(out)) == \
        [2, 3, 4, 5]


def _close(got: dict, want: dict, first: int):
    assert sorted(got) == sorted(want) and min(got) == first
    for s in got:
        rtol = 1e-4 if s == first else 2e-3
        np.testing.assert_allclose(got[s], want[s], rtol=rtol, atol=0,
                                   err_msg=f"step {s}")


def launchers_from_one_checkpoint(arch: str, capsys, tmp_path):
    """The port's initial weights of reduced `arch` as a step-0 checkpoint;
    the reference's launcher and the port's each resume from it for 4 steps
    (COMMON's flags): their printed losses agree.  Returns (the run's
    flags, the reference's losses, the reference's checkpoint dir)."""
    cfg = TC.get(arch, reduced=True)
    params = TR.build(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    start = str(tmp_path / "start")
    ST.save(start, 0, params)
    ST.save(start + "/opt", 0, OPT.init(params))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(start, ref_dir)
    shutil.copytree(start, port_dir)
    run = ["--arch", arch, "--reduced"] + COMMON + ["--steps", "4",
                                                    "--ckpt-every", "2"]

    RTRAIN.main(run + ["--ckpt-dir", ref_dir])
    ref_out = capsys.readouterr().out
    assert "[resume] step 0" in ref_out
    port_out = _port_main(capsys, run + ["--ckpt-dir", port_dir])
    assert "[resume] step 0" in port_out
    want = parse_losses(ref_out)
    _close(parse_losses(port_out), want, 0)
    return run, want, ref_dir


def test_launcher_parity_through_a_checkpoint(capsys, tmp_path):
    """The port's initial weights as a step-0 checkpoint; the reference's
    launcher and the port's each resume from it for 4 steps; then the port
    resumes from step 2 as the reference wrote it."""
    run, want, ref_dir = launchers_from_one_checkpoint("qwen1.5-4b", capsys,
                                                       tmp_path)

    from_ref = str(tmp_path / "from_ref")
    for sub in ("", "/opt"):
        shutil.copytree(f"{ref_dir}{sub}/step_00000002",
                        f"{from_ref}{sub}/step_00000002")
    out = _port_main(capsys, run + ["--ckpt-dir", from_ref])
    assert "[resume] step 2" in out
    _close(parse_losses(out), {s: want[s] for s in (2, 3)}, 2)


def test_accumulation_follows_the_reference():
    """`--accum 2`'s step against the reference's at equal weights (granite
    reduced to 2 layers, 16 experts top-4, float32): the same loss and grad
    norm with and without accumulation.  Its grad norm need not be the
    unaccumulated one's: the MoE load-balance loss is a product of batch
    means, so two half-batches have another; without it the two agree."""
    kw = dict(n_layers=2, n_experts=16, topk=4)
    rcfg = RC.get("granite-moe-1b-a400m", reduced=True).replace(**kw)
    tmodel = TR.build(TC.get("granite-moe-1b-a400m", reduced=True)
                      .replace(**kw))
    rmodel = RR.build(rcfg)
    module = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    rparams = reference_tree(module, rmodel.init, jax.random.key(0))
    batch = token_batch(0, 0, 4, 32, rcfg.vocab_size)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    norms = {}
    for aux in (0.01, 0.0):
        for accum in (1, 2):
            ttc = STEP.TrainConfig(compute_dtype=torch.float32, remat=False,
                                   accum_steps=accum, aux_weight=aux)
            _, _, met = STEP.make_train_step(tmodel, ttc, OPT.AdamWConfig())(
                module, OPT.init(module), batch)
            norms[aux, accum] = float(met["grad_norm"])
            if aux:
                rtc = RSTEP.TrainConfig(compute_dtype=jnp.float32,
                                        remat=False, accum_steps=accum)
                _, _, rmet = jit(RSTEP.make_train_step(
                    rmodel, rtc, ROPT.AdamWConfig()))(
                        rparams, ROPT.init(rparams), rb)
                for k in ("loss", "aux", "grad_norm"):
                    np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                               rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(norms[0.0, 2], norms[0.0, 1], rtol=1e-2)


def test_train_loss_improves():
    """The reference's `test_train_loss_improves`, through
    `python -m repro_torch.launch.train --device cpu`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-4b", "--reduced", "--device", "cpu", "--steps", "40",
         "--batch", "8", "--seq", "32", "--lr", "1e-3", "--log-every", "5"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    _check_loss_improves(r.stdout, steps=40, every=5)


def _check_loss_improves(stdout: str, steps: int, every: int):
    """The closing line says `improved`, and the logged steps are exactly
    range(0, steps, every).  The launcher also logs any straggler step
    (more than 2x the median step time) with a `[straggler]` marker, so a
    marked line off that grid is not a logged step; an unmarked one is."""
    assert "improved" in stdout and "NOT improved" not in stdout
    lines = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    logged = [ln for ln in lines if not ln.endswith("[straggler]")
              or int(ln.split()[1]) % every == 0]
    assert sorted(parse_losses("\n".join(logged))) == \
        list(range(0, steps, every))


def _stdout(steps, stragglers=(), closing="loss 5.6958 -> 5.5883 (improved)"):
    return "\n".join(
        [f"step {s:5d} loss {6 - s / 100:.4f} gnorm 1.000 lr 1.00e-03 "
         f"{0.5 if s in stragglers else 0.04:.2f}s"
         + (" [straggler]" if s in stragglers else "") for s in steps]
        + [closing]) + "\n"


def test_loss_check_takes_straggler_lines_and_misses_no_step():
    """`test_train_loss_improves`' check on made-up launcher output: a
    straggler's extra line (step 12) or a logged step that was a straggler
    (step 10) passes; a missing logged step, an unmarked extra step or a
    `NOT improved` closing line fails."""
    grid = list(range(0, 40, 5))
    _check_loss_improves(_stdout(sorted(grid + [12]), {12}), 40, 5)
    _check_loss_improves(_stdout(grid, {10}), 40, 5)
    for bad in (_stdout([s for s in grid if s != 10] + [12], {12}),
                _stdout(sorted(grid + [12])),
                _stdout(grid, closing="loss 5.5 -> 5.6 (NOT improved)")):
        with pytest.raises(AssertionError):
            _check_loss_improves(bad, 40, 5)
