"""The check that decides ``correct`` has to fail what is wrong.

* The control (the reference computed from float8 operands, one step
  below the configurations' bfloat16) put in the program's place fails a
  limit of each cell, while the program keeps them: on the CPU at a small
  size here, and on the card at the cell's own size (marked ``gpu``).
* A whole run with its timed path broken underneath comes out not
  correct: an answer altered where it is produced, and half of each batch
  left out; in a training cell also a step that leaves its state
  unchanged.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import pytest
import torch

from perfbench_small import MT_CELLS, SERVE_CELLS, TRAIN_CELLS, small_cell, small_train_cell


def _fails(row, limits):
    return any(row[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_control_fails_and_program_passes(name):
    from perfbench import control

    w, conf, mix = small_cell(name)
    rows = control.readings(w, conf, mix, [21], [22, 23], torch.device("cpu"), 1.0)
    limits = w["check"]["limits"]
    assert not _fails(rows[0], limits), rows[0]
    for row in rows[1:]:
        assert _fails(row, limits), row


@pytest.mark.parametrize("name", TRAIN_CELLS + MT_CELLS)
def test_training_control_and_faults_fail_and_program_passes(name):
    from perfbench import control

    w, conf, mix = small_train_cell(name)
    rows = control.readings(w, conf, mix, [21], [22], torch.device("cpu"), 1.0)
    limits = w["check"]["limits"]
    mt = name in MT_CELLS
    assert [r["kind"] for r in rows] == ["program", "control", "half_batch", "gradient"] + ["answer"] * mt
    assert not _fails(rows[0], limits), rows[0]
    # one leaf's gradient doubled is read, not held, in the mean-teacher cell:
    # its worst leaves swing with rounding there, and no steady number sees one leaf
    for row in rows[1:]:
        if not (mt and row["kind"] == "gradient"):
            assert _fails(row, limits), row


@pytest.mark.gpu
@pytest.mark.parametrize("name", SERVE_CELLS + TRAIN_CELLS + MT_CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import control
    from perfbench.harness import spec

    w = spec.workload(name)
    rows = control.readings(w, spec.config(w["config"]), spec.traffic(w["traffic"]), [31],
                            [32, 33, 34], torch.device("cuda", 0), 2.0, faults=False)
    assert not _fails(rows[0], w["check"]["limits"]), rows[0]
    for row in rows[1:]:
        assert _fails(row, w["check"]["limits"]), row


def _run(name, monkeypatch, fetch=None, dispatch=None):
    from mmt_psm_tpu_torch.engine import inference

    from perfbench.harness import main as M

    if fetch is not None:
        monkeypatch.setattr(inference.DeviceStage, "fetch", fetch)
    if dispatch is not None:
        monkeypatch.setattr(inference.DeviceStage, "dispatch", dispatch)
    w, conf, mix = small_cell(name)
    a = argparse.Namespace(seed=2**31 + 5, seconds=1.0, trace=0)
    return M.measure(a, torch.device("cpu"), time.perf_counter(), w, conf, mix)


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    assert _run(name, monkeypatch)["correct"] is True


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_answer_altered_is_not_correct(name, monkeypatch):
    from mmt_psm_tpu_torch.engine import inference

    fetch = inference.DeviceStage.fetch

    def altered(self, pending):
        boxes, scores, labels, valid, masks, head_ids = fetch(self, pending)
        i = np.flatnonzero(valid[0])[0]
        boxes = boxes.copy()
        boxes[0, i] += np.float32(24.0)  # one detection moved where the stage produces it
        return boxes, scores, labels, valid, masks, head_ids

    r = _run(name, monkeypatch, fetch=altered)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    from mmt_psm_tpu_torch.engine import inference

    fetch = inference.DeviceStage.fetch

    def half(self, pending):
        boxes, scores, labels, valid, masks, head_ids = fetch(self, pending)
        valid = valid.copy()
        valid[valid.shape[0] // 2:] = False  # the second half of each batch served nothing
        return boxes, scores, labels, valid, masks, head_ids

    r = _run(name, monkeypatch, fetch=half)
    assert r["correct"] is False, r["checks"]


def _train_run(name, monkeypatch, patches):
    from perfbench.harness import main as M

    for owner, attr, fn in patches:
        monkeypatch.setattr(owner, attr, fn)
    w, conf, mix = small_train_cell(name)
    a = argparse.Namespace(seed=2**31 + 5, seconds=1.0, trace=0)
    return M.measure(a, torch.device("cpu"), time.perf_counter(), w, conf, mix)


@pytest.mark.parametrize("name", TRAIN_CELLS + MT_CELLS)
def test_training_state_unchanged_is_not_correct(name, monkeypatch):
    from mmt_psm_tpu_torch.train import supervised

    def unchanged(self, total):  # the losses are computed, the state is not moved
        self.iteration += 1

    r = _train_run(name, monkeypatch, [(supervised.Trainer, "update", unchanged)])
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", TRAIN_CELLS + MT_CELLS)
def test_training_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    from mmt_psm_tpu_torch.train import mean_teacher, supervised

    owner = mean_teacher.MTTrainer if name.startswith("mt_") else supervised.Trainer
    step = owner.step

    def half(self, *batches):  # the losses the mean over the first half of each batch's rows
        return step(self, *({k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches))

    r = _train_run(name, monkeypatch, [(owner, "step", half)])
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_gradient_altered_is_not_correct(name, monkeypatch):
    from mmt_psm_tpu_torch.train import supervised

    clip = supervised.clip_grad_norm_

    def altered(tensors, max_norm):  # one leaf's gradient doubled where the step produces it
        norm = clip(tensors, max_norm)
        tensors[0].grad.mul_(2.0)
        return norm

    r = _train_run(name, monkeypatch, [(supervised, "clip_grad_norm_", altered)])
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", MT_CELLS)
def test_training_answer_altered_is_not_correct(name, monkeypatch):
    from mmt_psm_tpu_torch.models.detector import MaskRCNN

    from perfbench import control

    # one pseudo-label of each image moved where the teacher produces it
    moved = control.moved_pseudo_labels(MaskRCNN.detections_from_features)
    r = _train_run(name, monkeypatch, [(MaskRCNN, "detections_from_features", moved)])
    assert r["correct"] is False, r["checks"]
