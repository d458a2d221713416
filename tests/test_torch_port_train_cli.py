"""The port's train CLI (``python -m mmt_psm_tpu_torch.tools.train_mean_teacher``)
on the CPU: ``main(argv)`` with ``--synthetic --device cpu`` at a 128
canvas (``torch_port_util.TRAIN_OPTS``) trains across START_MT, writes
``config.yaml``, the checkpoints, the tag, ``log.txt`` and
``final_eval.json`` with the JAX CLI's keys (``tools/train_mean_teacher.py:
155-161``), and a second call resumes from the tag (at its iteration, with
no step left to take). ``--weights`` loads a
``.pth`` into the student and the teacher starts as its copy. Without
``--device`` and with no card it raises.
"""

import json
import os

import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu_torch.config import get_cfg, load_yaml
from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg
from mmt_psm_tpu_torch.tools.train_mean_teacher import main
from mmt_psm_tpu_torch.utils.checkpoint import Checkpointer

U.setup_torch()

JAX_EVAL_KEYS = {"AJI", "AJI_mean", "mAP", "AP50", "images_per_sec"}


def files(d):
    return sorted(f for f in os.listdir(d) if not f.endswith(".tmp"))


def test_train_cli_trains_resumes_and_scores(tmp_path):
    out = str(tmp_path / "run")
    flags = ["--synthetic", "--device", "cpu", "--output-dir", out]
    # the val sweep's mask head on 16 detections an image, not 200
    opts = U.TRAIN_OPTS + ["MT.START_MT", "0", "SOLVER.CHECKPOINT_PERIOD", "1", "TEST.EVAL_WORKERS", "0",
                           "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", "16"]
    try:
        res = main(flags + opts + ["SOLVER.MAX_ITER", "2"])
        assert res["start_iter"] == 0
        assert files(out) == ["config.yaml", "final_eval.json", "last_checkpoint", "log.txt", "model_0000001.pth",
                              "model_final.pth", "t_model_0000001.pth", "t_model_final.pth"]
        cfg = get_cfg()
        with open(os.path.join(out, "config.yaml")) as f:
            cfg.merge_from_dict(load_yaml(f.read()))
        assert cfg == res["trainer"].cfg and cfg.SOLVER.MAX_ITER == 2 and cfg.TPU.IMAGE_SIZE == 128
        with open(os.path.join(out, "final_eval.json")) as f:
            summary = json.load(f)
        assert set(summary) == JAX_EVAL_KEYS and summary == res["final_eval"]
        assert set(summary["AJI"]) == {"1", "2"} and summary["images_per_sec"] > 0
        ckpt = Checkpointer(out)
        assert ckpt.last_name() == "model_final"
        final = ckpt.load()
        assert final["iteration"] == 2 and set(final) == {"model", "optimizer", "scheduler", "iteration", "teacher",
                                                          "generator"}
        assert final["scheduler"]["last_epoch"] == 2
        teacher = ckpt.load("t_model_final")
        assert all(torch.equal(teacher["model"][k], v) for k, v in final["teacher"].items())
        with open(os.path.join(out, "log.txt")) as f:
            log = f.read()
        assert "iter: 0 " in log and "iter: 1 " in log and "mt_weight" in log  # iteration 1 took the MT step

        # the resume: the tag's iteration, and no step left (a resumed step is
        # test_torch_port_train_loop.py::test_resume_is_bit_exact's)
        res = main(flags + ["--skip-test"] + opts + ["SOLVER.MAX_ITER", "2"])
        assert res["start_iter"] == 2 and res["final_eval"] is None
        assert res["trainer"].steps.iteration == 2
        again = Checkpointer(out).load()
        assert again["iteration"] == 2 and all(torch.equal(again["model"][k], v) for k, v in final["model"].items())
        with open(os.path.join(out, "final_eval.json")) as f:
            assert json.load(f) == summary  # --skip-test leaves it
        with open(os.path.join(out, "log.txt")) as f:
            assert "resumed from model_final at iteration 2" in f.read()
    finally:
        for f in os.listdir(out):
            if f.endswith(".pth"):
                os.remove(os.path.join(out, f))


def test_train_cli_weights_init_student_and_teacher(tmp_path):
    """``--weights`` in transfer mode: the student takes the file's tensors
    (not the class-count heads), and the teacher starts equal to it. No
    iteration runs (MAX_ITER 0): model_final holds the initial state."""
    src = model_from_cfg(load_config(U.FLAGSHIP, ["TPU.IMAGE_SIZE", 128]), "cpu", seed=5).state_dict()
    weights = str(tmp_path / "init.pth")
    torch.save({"model": {f"module.{k}": v for k, v in src.items()}}, weights)
    out = str(tmp_path / "run")
    main(["--synthetic", "--device", "cpu", "--output-dir", out, "--weights", weights, "--skip-test"]
         + U.TRAIN_OPTS + ["SOLVER.MAX_ITER", "0"])
    final = Checkpointer(out).load()
    student, teacher = final["model"], final["teacher"]
    assert all(torch.equal(student[k], teacher[k]) for k in teacher)
    assert torch.equal(student["backbone.body.layer2.0.conv1.weight"], src["backbone.body.layer2.0.conv1.weight"])
    assert not torch.equal(student["roi_heads.box.predictor.cls_score.weight"],
                           src["roi_heads.box.predictor.cls_score.weight"])
    assert "hint_adaptor.adapter_1.weight" in student  # the training graph's adaptor keeps its init
    os.remove(os.path.join(out, "model_final.pth"))


def test_train_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "--output-dir", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")
