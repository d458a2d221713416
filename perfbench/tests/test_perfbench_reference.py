"""The plain reference against the program on the CPU at a 128 canvas in
float32: both configurations' test-time forward, and the supervised
training step, from the same weights, inputs and random draws. On the CPU
the program runs its own plain NMS and ROIAlign, so the two are the same
arithmetic and agree to float32 rounding."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from perfbench_small import CANVAS, SERVE_CELLS, TRAIN_CELLS, MT_CELLS, small_cell, small_train_cell


def _pair(name):
    from perfbench.harness.weights import fill
    from perfbench.paths.program import program_model
    from perfbench.reference.build import reference_model

    w, conf, _ = small_cell(name)
    conf = dict(conf, model=dict(conf["model"], compute_dtype="float32"),
                program=dict(conf["program"], opts=[*conf["program"]["opts"], "TPU.COMPUTE_DTYPE", "float32"]))
    if conf["model"].get("relation_mask"):
        conf["model"]["relation_mask"] = dict(conf["model"]["relation_mask"], compute_dtype="float32")
    prog = fill(program_model(conf, "cpu"), 5, conf["init"])
    ref = fill(reference_model(conf["model"], "cpu"), 5, conf["init"]).eval()
    return prog, ref


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_same_parameters(name):
    prog, ref = _pair(name)
    a, b = dict(prog.named_parameters()), dict(ref.named_parameters())
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_forward_matches_program(name):
    from mmt_psm_tpu_torch.engine.inference import DeviceStage

    from perfbench.reference import serve as RS

    prog, ref = _pair(name)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, CANVAS, CANVAS, 3)).astype(np.uint8)
    sizes = np.array([[CANVAS - 8, CANVAS], [CANVAS, CANVAS - 16]], np.int32)
    stage = DeviceStage(prog)
    boxes, scores, labels, valid, masks, _ = stage.fetch(stage.dispatch({"image": images, "image_size": sizes}))
    dets, feats = RS.detect(ref, torch.from_numpy(images), torch.from_numpy(sizes))
    assert valid.sum() > 0
    np.testing.assert_array_equal(valid, dets.valid.numpy())
    np.testing.assert_array_equal(labels, dets.labels.numpy())
    np.testing.assert_allclose(boxes, dets.boxes.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(scores, dets.scores.numpy(), rtol=1e-5, atol=1e-5)
    # the device stage serves float16 probabilities: half an ulp of float16 at 1
    np.testing.assert_allclose(masks.astype(np.float32), dets.masks.numpy(), atol=2.5e-4)
    on_served = RS.masks_on(ref, feats, torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid))
    np.testing.assert_allclose(on_served.numpy(), dets.masks.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", TRAIN_CELLS + MT_CELLS)
def test_training_steps_match_program(name):
    from perfbench.judge import training as J

    w, conf, mix = small_train_cell(name)
    conf = dict(conf, model=dict(conf["model"], compute_dtype="float32"),
                program=dict(conf["program"], opts=[*conf["program"]["opts"], "TPU.COMPUTE_DTYPE", "float32"]))
    if conf["model"].get("relation_mask"):
        conf["model"]["relation_mask"] = dict(conf["model"]["relation_mask"], compute_dtype="float32")
    run = importlib.import_module(f"perfbench.paths.{w['path']}").Run(w, conf, mix, 9, torch.device("cpu"), 0.0)
    run.setup()
    run.free()
    ref = J.reference_record(run)
    np.testing.assert_allclose(run.losses, ref["losses"], rtol=1e-5)
    for n, want in ref["after"].items():
        np.testing.assert_allclose(run.after[n].numpy(), want.numpy(), rtol=1e-4, atol=1e-7, err_msg=n)
    for n, want in ref["buffers"].items():
        np.testing.assert_allclose(run.first_buffers[n].numpy(), want.numpy(), rtol=1e-4, atol=1e-7, err_msg=n)
    for n, want in ref.get("teacher", {}).items():
        np.testing.assert_allclose(run.teacher_after[n].numpy(), want.numpy(), rtol=1e-4, atol=1e-7, err_msg=n)
