"""The training loop and both CLIs at two gloo ranks against one process, on
the CPU.

``torch_port_dist.cli_run``: the train CLI (``--synthetic``, the flagship at
``torch_port_util.TRAIN_OPTS``' 128 canvas, a global batch of 2 labeled
and 2 unlabeled images, ``--weights`` the seed-0 student with the relation
head's gate off its pole) for 2 supervised iterations, its checkpoints and
the val sweep, then the same command resumed for a
third, the MT step past START_MT 1, then the test CLI over its ``model_final`` (at W = 1 over
the same file); at W = 2 (the
ranks each assembling the global batches from the loaders' seeds and
keeping their rows) in one directory, and at W = 1 in another, both with
PyTorch's own CPU convolution. The loop's losses of every iteration agree
within 1e-4 relative, the port's step tests' loss bound (each rank logs the
global batch's; one step's losses agree within 2e-5, but the float32
differences of the updates compound: 2.4e-5 on ``loss_box_reg`` at the third
iteration, and at a fourth a proposal crosses the top-k cut, which moves
the losses by percents even between one process's runs with and without
oneDNN), both ranks resume at iteration 2 from rank 0's file, rank 0 alone writes the log and the
files, every rank returns the whole val split's summary, and the test CLI's
sharded sweep equals one process's within 1e-12.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_port_dist as D
import torch_port_util as U

U.setup_torch()

OPTS = [*U.TRAIN_OPTS, "MT.START_MT", "1", "SOLVER.CHECKPOINT_PERIOD", "100", "TEST.EVAL_WORKERS", "0",
        "TEST.IMS_PER_BATCH", "2"]
OPTS[OPTS.index("SOLVER.IMS_PER_BATCH") + 1] = "2"
LOOP_RTOL = 1e-4


def _no_rate(summary: dict) -> dict:
    """A summary without its images/s, which each rank times itself."""
    return {k: v for k, v in summary.items() if k != "images_per_sec"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmt_psm_tpu_torch.train import build_mt_trainer

    root2, root1 = tmp_path_factory.mktemp("w2"), tmp_path_factory.mktemp("w1")
    # the seed-0 student with the relation head's geometric gate off its pole
    # (torch_port_util's WG bias), through --weights (transfer mode)
    weights = str(root1 / "weights.pth")
    sd = build_mt_trainer(device="cpu", seed=0, opts=OPTS).model.state_dict()
    sd["relation_nms.relation_module.WG.bias"].fill_(D.WG_BIAS)
    torch.save({"model": sd}, weights)
    del sd
    world = D.World(D.cli_rank, 2, root2 / "world", args=(str(root2), OPTS, weights), timeout=900)
    try:
        one = D.cli_run(str(root1), OPTS, weights, test_cli=False)
    except BaseException:
        world.kill()
        raise
    ranks = world.wait()
    # one process's sweep of the same checkpoint
    os.makedirs(root1 / "ckpt")
    shutil.copy(root2 / "ckpt" / "model_final.pth", root1 / "ckpt")
    one["tested"] = D.test_net_run(str(root1 / "ckpt"), OPTS)
    return ranks, one, root2


def test_loop_losses_equal_one_process(runs):
    ranks, one, _ = runs
    for key in ("losses", "resumed"):
        want = one[key]
        assert len(want["loss_total"]) == (2 if key == "losses" else 1)
        assert ("mt_classifier" in want) == (key == "resumed")
        for r in ranks:
            assert set(r[key]) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(r[key][k], w, rtol=LOOP_RTOL, atol=0, err_msg=f"{key} {k}")
        assert ranks[0][key] == ranks[1][key]


def test_every_rank_resumes_from_rank_zeros_file(runs):
    ranks, one, root = runs
    assert [r["starts"] for r in ranks] == [(0, 2), (0, 2)] and one["starts"] == (0, 2)
    names = sorted(os.listdir(root / "run"))
    assert {"model_final.pth", "t_model_final.pth", "last_checkpoint", "config.yaml", "log.txt",
            "final_eval.json"} <= set(names)
    assert not [n for n in names if n.endswith(".tmp")]


def test_one_writer(runs):
    """The log has each line once (rank 1 logs nothing), the files are rank
    0's; every rank returns the whole split's val summary."""
    ranks, one, root = runs
    log = (root / "run" / "log.txt").read_text().splitlines()
    assert [sum(f"iter: {i} " in line for line in log) for i in range(3)] == [1, 1, 1]
    assert sum("resumed from model_final at iteration 2" in line for line in log) == 1
    assert sum("data-parallel mesh: 2 process(es) over gloo" in line for line in log) == 2
    summary = json.loads((root / "run" / "final_eval.json").read_text())
    assert ranks[0]["final_eval"] == summary
    assert _no_rate(ranks[1]["final_eval"]) == _no_rate(summary)
    assert set(summary) == set(one["final_eval"])


def test_sharded_test_cli_equals_one_process(runs):
    ranks, one, root = runs
    assert [{n: _no_rate(v) for n, v in r["tested"].items()} for r in ranks] == [
        {n: _no_rate(v) for n, v in ranks[0]["tested"].items()}] * 2
    (name, got), = ranks[0]["tested"].items()
    want = one["tested"][name]
    assert json.loads((root / "ckpt" / "result.json").read_text()) == ranks[0]["tested"]
    for key in ("AJI_mean", "mAP", "AP50", "AP75", "AP85"):
        assert abs(got[key] - want[key]) <= 1e-12, key
    for key in ("AJI", "F1"):
        assert set(got[key]) == set(want[key])
        for c in want[key]:
            assert abs(got[key][c] - want[key][c]) <= 1e-12, (key, c)
