"""Elastic restart and the sharded trainer across ranks: eight CPU
processes joined by gloo (`torch_dist.spawn`) resume a checkpoint saved on
one mesh on another (`checkpoint/elastic.py`), and run the launcher with
`--mesh debug` (the reference's (2, 4) mesh) through a checkpoint and a
resume, against the same run without a mesh in this process."""

import numpy as np
import pytest

from repro_torch.launch import train as TRAIN

import torch_dist

ARGS = ["--arch", "qwen1.5-4b", "--reduced", "--batch", "8", "--seq", "16",
        "--lr", "1e-3", "--lr-total-steps", "6", "--log-every", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    inputs = {"elastic": {"root": str(root / "el")},
              "launcher": {"root": str(root / "run"), "args": ARGS}}
    return torch_dist.spawn(torch_dist.run_scenarios, 8, root / "rdv",
                            ["elastic", "launcher"], inputs)


def _results(runs, name):
    per_rank = [o[name] for o in runs]
    for r, o in enumerate(per_rank):
        if isinstance(o, dict) and "error" in o:
            raise AssertionError(f"{name} failed on rank {r}:\n{o['error']}")
    return per_rank


def test_resume_or_init_across_meshes(runs):
    """A fresh start places the init's values; a checkpoint saved on
    (2, 4) resumes on (4, 2) bit-equal at its step with the new mesh's
    placements; a lagging `opt` restarts the optimizer state; a global
    batch the data axes do not divide raises."""
    for o in _results(runs, "elastic"):
        assert o["fresh_step"] == 0 and o["fresh_equal"]
        assert o["resume_step"] == 3 and o["opt_step"] == 3
        assert o["params_equal"] and o["m_equal"]
        assert o["wq_placements"] == "(Shard(dim=1), Shard(dim=2))"
        assert o["lagging_opt"] == (3, 0, 0.0)
        assert "not divisible" in o["divisibility"]


def test_launcher_mesh_debug_matches_unsharded_and_resumes(runs):
    """`--mesh debug --ckpt-dir` on 8 ranks: every rank's losses within
    2e-3 of the unsharded launcher's, and the second run resumes at step
    2 through elastic.resume_or_init."""
    plain = TRAIN.main(ARGS + ["--steps", "3", "--device", "cpu"])
    for o in _results(runs, "launcher"):
        assert len(o["first"]) == 2 and len(o["resumed"]) == 1
        np.testing.assert_allclose(o["first"] + o["resumed"], plain,
                                   rtol=2e-3, atol=2e-3)
