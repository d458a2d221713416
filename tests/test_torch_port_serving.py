"""The port's serving path against the JAX package's on the CPU: the
inference engine (``run_inference``), the host paste on the JAX model's
own detections, the pool of eval workers, the ``Checkpointer``, the test
CLI and ``CellDemo``.

Both models are the flagship graph at a 128 canvas in float32 with the
same weights (``torch_port_util.build_pair``), with 16 proposals an image
after the RPN (32 detection slots), over the windows of a synthetic slide
(raw uint8 canvases, normalized on the model's device) whose gt are the
JAX model's own instances (``PseudoGT``). The host half is held exact on
the same detections. End to end, the port's detections
differ from JAX's by float32 noise (``test_torch_port_e2e.py``: valid and
labels identical, probabilities within 5e-3), and the paste thresholds the
probabilities at 0.5, so a pixel whose probability lies within that noise
of 0.5 may flip. STATS_ATOL bounds what such flips can move: a few pixels
of instances of hundreds move an IoU, an AJI, a DSC or a TPR by under
1e-2; F1, FNRo, FDRo and the mAPs count matches at IoU thresholds and
move only where an IoU sits within that of a threshold, which the test's
data do not have, so they are held to the same bound. The first run
measured every stat identical.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.data import loader as jloader
from mmt_psm_tpu.data import pap as jpap
from mmt_psm_tpu.engine import inference as jinf
from mmt_psm_tpu.engine import paste as jpaste
from mmt_psm_tpu.engine.predictor import CellDemo as JCellDemo
from mmt_psm_tpu.evaluation import pap_eval as jpe
from mmt_psm_tpu_torch.data import loader, pap
from mmt_psm_tpu_torch.engine import inference as inf
from mmt_psm_tpu_torch.engine import paste
from mmt_psm_tpu_torch.engine.predictor import CellDemo
from mmt_psm_tpu_torch.evaluation import pap_eval as pe
from mmt_psm_tpu_torch.tools import test_net
from mmt_psm_tpu_torch.utils.checkpoint import Checkpointer, load_model_weights

U.setup_torch()

FPN_POST = 16  # proposals an image after the RPN: 2 x 16 detection slots
STATS_ATOL = 1e-2
SLIDES = dict(seed=42, num_slides=1, slide_size=256, win_size=128, overlap=0.0, is_train=False)
LOADER = dict(max_gt=16, min_size=128, max_size=128, raw_u8=True)
BATCH = 3  # 4 windows: batches of 3 and 1 (padded to 3)
# the JAX CLI's result.json keys (tools/test_net.py:98-107)
RESULT_KEYS = {"AJI", "AJI_mean", "mAP", "AP50", "AP75", "AP85", "F1", "images_per_sec"}


@pytest.fixture(scope="module")
def pair():
    jm, params, tm, _ = U.build_pair(fpn_post_nms_top_n_test=FPN_POST)
    return jm, params, tm


class PseudoGT:
    """The windows of a synthetic slide whose gt are the JAX model's own
    pasted instances (at most MAX_GT), every other one moved 2 px right,
    so that both engines meet gt their detections overlap, at IoUs spread
    over (0.5, 1], and the stats are not those of random weights against
    unrelated cells."""

    def __init__(self, jm, params, ds):
        self.items = []
        for batch in jloader.make_test_loader(ds, BATCH, 128, **LOADER):
            boxes, scores, labels, valid, masks, _ = jax.device_get(
                jinf._cached_infer(jm)(params, batch["image"], batch["image_size"]))
            for i in range(batch["n_real"]):
                dt = jpaste.detections_to_instseg(boxes[i], scores[i], labels[i], valid[i],
                                                  np.asarray(masks[i], np.float32), (128, 128))
                gt_boxes, gt_labels, gt_masks = [], [], []
                for c, inst in sorted(dt.items()):
                    for k, (b, m) in enumerate(zip(inst.boxes, inst.masks)):
                        full = np.zeros((128, 128), np.uint8)
                        full[b[1] : b[3] + 1, b[0] : b[2] + 1] = m
                        if k % 2:
                            full = np.pad(full, ((0, 0), (2, 0)))[:, :128]
                        ys, xs = np.nonzero(full)
                        if len(ys) < 4:
                            continue
                        gt_boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
                        gt_labels.append(c)
                        gt_masks.append(full)
                n = min(len(gt_boxes), LOADER["max_gt"])
                self.items.append({"image": batch["image"][i], "boxes": np.asarray(gt_boxes, np.float32)[:n],
                                   "labels": np.asarray(gt_labels, np.int32)[:n],
                                   "masks": np.asarray(gt_masks, np.uint8)[:n]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def datasets(pair):
    jm, params, _ = pair
    return PseudoGT(jm, params, jpap.synthetic_slide_dataset(**SLIDES))


@pytest.fixture(scope="module")
def port_run(pair, datasets):
    _, _, tm = pair
    return inf.run_inference(tm, loader.make_test_loader(datasets, BATCH, 128, **LOADER), eval_workers=0)


def assert_stats_close(got, want, atol):
    assert set(got) == set(want)
    for metric in want:
        assert set(got[metric]) == set(want[metric]), metric
        for k, w in want[metric].items():
            assert abs(got[metric][k] - w) <= atol, (metric, k, got[metric][k], w)


def test_run_inference_matches_jax(pair, datasets, port_run):
    jm, params, _ = pair
    want, wt = jinf.run_inference(jm, params, jloader.make_test_loader(datasets, BATCH, 128, **LOADER),
                                  eval_workers=0)
    got, gt_ = port_run
    assert gt_["images"] == wt["images"] == 4
    assert set(gt_["stage_seconds"]) == {"loader", "device", "gt", "score"}
    assert_stats_close(got, want, STATS_ATOL)
    assert got["AJI"][1] > 0 and got["mAP"]["all"] > 0  # the comparison is not of zeros
    assert all(np.isfinite(v) for m in got.values() for v in m.values())


def test_host_eval_identical_on_jax_detections(pair, datasets):
    """The JAX model's detections of a batch (float16 probabilities, as both
    engines hand them to the host), pasted and scored by both packages:
    identical instance masks, gt conversion and per-image stats."""
    jm, params, _ = pair
    batch = next(jloader.make_test_loader(datasets, BATCH, 128, **LOADER))
    boxes, scores, labels, valid, masks, _ = jax.device_get(
        jinf._cached_infer(jm)(params, batch["image"], batch["image_size"]))
    masks = np.asarray(masks, np.float32)
    ours, theirs = pe.PapEvaluator(), jpe.PapEvaluator()
    n_inst = 0
    for i in range(BATCH):
        hw = tuple(batch["image_size"][i].tolist())
        dt = paste.detections_to_instseg(boxes[i], scores[i], labels[i], valid[i], masks[i], hw)
        jdt = jpaste.detections_to_instseg(boxes[i], scores[i], labels[i], valid[i], masks[i], hw)
        gt_args = (batch["boxes"][i], batch["labels"][i], batch["gt_valid"][i], batch["masks"][i])
        gt, jgt = paste.gt_to_instseg(*gt_args), jpaste.gt_to_instseg(*gt_args)
        for a, b in ((dt, jdt), (gt, jgt)):
            assert set(a) == set(b)
            for c in b:
                np.testing.assert_array_equal(a[c].boxes, b[c].boxes)
                assert len(a[c]) == len(b[c])
                n_inst += len(a[c])
                for x, y in zip(a[c].masks, b[c].masks):
                    np.testing.assert_array_equal(x, y)
                if b[c].scores is not None:
                    np.testing.assert_array_equal(a[c].scores, b[c].scores)
        ours.add_image(dt, gt)
        theirs.add_image(jdt, jgt)
    assert n_inst > 20
    assert ours.summarize() == theirs.summarize()


def test_pool_identical_to_serial(pair, datasets, port_run):
    """Two spawned workers paste and score; rows come back in image order,
    so every stat is identical to the serial run's."""
    _, _, tm = pair
    got, timing = inf.run_inference(tm, loader.make_test_loader(datasets, BATCH, 128, **LOADER),
                                    eval_workers=2, prefetch_depth=0)
    assert timing["images"] == 4
    assert got == port_run[0]


def test_device_stage_refuses_float_canvases(pair, datasets):
    """The device stage normalizes raw uint8 canvases only: canvases
    normalized on the host (the test loader's float32 default) raise
    instead of being taken as they are."""
    _, _, tm = pair
    with pytest.raises(TypeError, match="raw uint8"):
        inf.run_inference(tm, loader.make_test_loader(datasets, BATCH, 128, **dict(LOADER, raw_u8=False)),
                          prefetch_depth=0)


def test_unported_options_raise(pair, tmp_path):
    """JAX's ``mesh`` argument has no counterpart (the sharded evaluation,
    held in tests/test_torch_port_parallel.py, takes its shard from the
    loader's indices); overlays and .mat export came with item 20
    (tests/test_torch_port_datasets_slice.py holds their files to JAX's)."""
    _, _, tm = pair
    with pytest.raises(TypeError, match="mesh"):
        inf.run_inference(tm, [], mesh=object())
    for kw in (dict(visual_num=1, visual_dir=str(tmp_path / "v")), dict(mat_dir=str(tmp_path / "m"))):
        _, timing = inf.run_inference(tm, [], **kw)
        assert timing["images"] == 0


def test_checkpointer_round_trip(tmp_path, pair):
    _, _, tm = pair
    ck = Checkpointer(str(tmp_path))
    assert not ck.has_checkpoint() and ck.last_name() is None
    with pytest.raises(FileNotFoundError):
        ck.load()
    sd = tm.state_dict()
    teacher = {k: v + 1 if v.is_floating_point() else v for k, v in sd.items()}
    ck.save("model_0000050", {"model": sd, "iteration": 50})
    ck.save("t_model_0000050", {"model": teacher}, tag=False)
    path = ck.save("model_0000100", {"model": sd, "iteration": 100, "nested": {"lr": [0.1, 0.2]}})
    assert path == os.path.join(str(tmp_path), "model_0000100.pth")
    assert (tmp_path / "last_checkpoint").read_text() == "model_0000100" == ck.last_name()
    assert ck.names() == ["model_0000050", "model_0000100", "t_model_0000050"]
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    latest = ck.load()
    assert latest["iteration"] == 100 and latest["nested"] == {"lr": [0.1, 0.2]}
    assert set(latest["model"]) == set(sd)
    for k, v in sd.items():
        assert latest["model"][k].dtype == v.dtype and torch.equal(latest["model"][k], v), k
    t = ck.load("t_model_0000050")["model"]
    assert all(torch.equal(t[k], teacher[k]) for k in sd)
    # the weights come back in place; a checkpoint of another graph does not load
    model = type(tm)(tm.config)
    load_model_weights(model, dict(t, **{"hint_adaptor.adapter_1.weight": torch.zeros(1)}))
    assert all(torch.equal(model.state_dict()[k], teacher[k]) for k in sd)
    with pytest.raises(KeyError, match="missing"):
        load_model_weights(model, {k: v for k, v in t.items() if not k.startswith("rpn.")})


# 8 proposals an image (16 detection slots): the sweep runs 16 windows on the CPU
CLI_OPTS = ["TPU.IMAGE_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
            "MODEL.RPN.POST_NMS_TOP_N_TEST", "64", "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "8",
            "TEST.IMS_PER_BATCH", "4", "TEST.EVAL_WORKERS", "0"]


def test_cli_sweeps_checkpoints(tmp_path, pair, monkeypatch):
    """``--synthetic --device cpu`` over a student and a teacher checkpoint:
    result.json and best_result.json with the JAX CLI's keys, each row
    equal to run_inference on that checkpoint's weights; without
    ``--device`` on a host with no card it raises."""
    from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg

    _, _, tm = pair
    ck = Checkpointer(str(tmp_path / "ckpt"))
    sd = tm.state_dict()
    ck.save("model_0000001", {"model": sd})
    ck.save("t_model_0000001", {"model": {k: v * 0.5 if k.startswith("roi_heads.mask.predictor") else v
                                          for k, v in sd.items()}}, tag=False)
    out = tmp_path / "out"
    argv = ["--config-file", U.FLAGSHIP, "--ckpt-dir", str(tmp_path / "ckpt"), "--synthetic", "--output-dir",
            str(out), "--device", "cpu", *CLI_OPTS]
    results = test_net.main(argv)
    written = json.loads((out / "result.json").read_text())
    best = json.loads((out / "best_result.json").read_text())
    assert list(written) == ["model_0000001", "t_model_0000001"]
    assert all(set(row) == RESULT_KEYS for row in written.values())
    (name, row), = best.items()
    assert row == written[name] and row["AJI_mean"] == max(r["AJI_mean"] for r in written.values())

    model = model_from_cfg(load_config(U.FLAGSHIP, CLI_OPTS), "cpu")
    load_model_weights(model, sd)
    ds = pap.synthetic_slide_dataset(seed=42, num_slides=2, slide_size=256, win_size=128, overlap=0.0,
                                     is_train=False)
    stats, timing = inf.run_inference(model, loader.make_test_loader(ds, 4, 128, **LOADER), eval_workers=0)
    assert timing["images"] == 8
    want = test_net.summary(stats, timing)
    row = dict(written["model_0000001"])
    assert json.loads(json.dumps({k: v for k, v in want.items() if k != "images_per_sec"})) == {
        k: v for k, v in row.items() if k != "images_per_sec"}
    assert results["model_0000001"]["AJI"] == row["AJI"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_net.main(argv[:-len(CLI_OPTS) - 2] + CLI_OPTS)


@pytest.mark.parametrize("opt", [["INPUT.PIXEL_MEAN", "[0.0, 0.0, 0.0]"], ["INPUT.PIXEL_STD", "[57.4, 57.1, 58.4]"]])
def test_cli_refuses_a_normalization_the_device_stage_ignores(tmp_path, opt):
    """The device stage subtracts the constant PIXEL_MEAN_BGR and divides
    by nothing: a config asking for another mean or std raises before any
    model is built."""
    argv = ["--ckpt-dir", str(tmp_path), "--synthetic", "--device", "cpu", *opt]
    with pytest.raises(NotImplementedError, match=opt[0].split(".")[1]):
        test_net.main(argv)


def test_cell_demo_matches_jax(pair):
    """One 128-px image through both predictors: the same kept detections,
    scores and boxes within 5e-3, pasted masks within a few pixels."""
    jm, params, tm = pair
    img = pap.synthetic_slide_dataset(**dict(SLIDES, seed=3))[0]["image"]
    got = CellDemo(tm, canvas=128, min_size=128, confidence_threshold=0.0).compute_prediction(img)
    want = JCellDemo(jm, params, canvas=128, min_size=128, confidence_threshold=0.0).compute_prediction(img)
    assert len(want["labels"]) > 5
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["label_names"] == want["label_names"]
    U.assert_close(got["boxes"], want["boxes"], atol=5e-3, what="boxes")
    U.assert_close(got["scores"], want["scores"], atol=5e-3, what="scores")
    assert set(got["masks"]) == set(want["masks"])
    for c, w in want["masks"].items():
        g = got["masks"][c]
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.areas > 0, w.areas > 0)
        assert np.abs(g.areas - w.areas).max() <= 0.02 * w.areas.max() + 2
    # the overlay of the prediction (JAX engine/predictor.py:68), on the port's own detections
    demo = CellDemo(tm, canvas=128, min_size=128, confidence_threshold=0.0)
    from mmt_psm_tpu_torch.utils.visual import overlay_instances

    overlay = demo.run_on_image(img)
    assert overlay.dtype == np.uint8 and overlay.shape == img.shape and (overlay != img).any()
    np.testing.assert_array_equal(overlay, overlay_instances(img, demo.compute_prediction(img)))
