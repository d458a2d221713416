"""The port's COCO and VOC evaluators and the dataset-level ``evaluate``
against the JAX package's on the CPU: ``box_iou_matrix``, ``CocoEvaluator``
(bbox and segm), ``voc_ap``, ``voc_eval``, ``eval_detection_voc``,
``do_voc_evaluation`` and ``evaluate`` over COCO, VOC, Pap and a
one-member concatenation. The same predictions (made from a seed, with
tied scores so the mergesort order counts) go to both; every summary
equal to 1e-12.
"""

import os

import numpy as np
import pytest

import torch_port_datasets as D
from mmt_psm_tpu import evaluation as jev
from mmt_psm_tpu.data import coco as jcoco
from mmt_psm_tpu.data import concat as jconcat
from mmt_psm_tpu.data import pap as jpap
from mmt_psm_tpu.data import voc as jvoc
from mmt_psm_tpu.engine import paste as jpaste
from mmt_psm_tpu.evaluation import coco_eval as jce
from mmt_psm_tpu.evaluation import voc_eval as jve
from mmt_psm_tpu_torch import evaluation as ev
from mmt_psm_tpu_torch.data import coco, concat, pap, voc
from mmt_psm_tpu_torch.engine import paste
from mmt_psm_tpu_torch.evaluation import coco_eval as ce
from mmt_psm_tpu_torch.evaluation import voc_eval as ve

TOL = 1e-12


def assert_close(got, want, what=""):
    """Nested summaries: the same keys, numbers within TOL (nan as nan)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple, np.ndarray)) and np.ndim(want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, equal_nan=True, err_msg=what)
    else:
        assert (np.isnan(want) and np.isnan(got)) or abs(got - want) <= TOL, (what, got, want)


def predictions_for(samples, seed, n_fp=4, mask=True):
    """Per sample, a prediction dict of the engine's form: each gt box moved
    by up to 2 px with its label (a third of them another label), plus
    ``n_fp`` random boxes, scores rounded to 0.1 (ties), a few invalid
    rows; 28 x 28 probabilities of a filled ellipse."""
    rng = np.random.default_rng(seed)
    preds = []
    for s in samples:
        h, w = s["image"].shape[:2]
        gt_boxes, gt_labels = np.asarray(s["boxes"], np.float32), np.asarray(s["labels"])
        xy = rng.uniform(0, [w * 0.6, h * 0.6], (n_fp, 2))
        fp = np.concatenate([xy, xy + rng.uniform(3, 12, (n_fp, 2))], 1)
        boxes = np.concatenate([gt_boxes + rng.uniform(-2, 2, gt_boxes.shape), fp]).astype(np.float32)
        boxes = np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
        labels = np.concatenate([np.where(rng.random(len(gt_labels)) < 0.33, 1 + (gt_labels % 3), gt_labels),
                                 rng.integers(1, 4, n_fp)]).astype(np.int32)
        k = len(boxes)
        p = {"boxes": boxes, "scores": np.round(rng.uniform(0.05, 1, k), 1).astype(np.float32), "labels": labels,
             "valid": rng.random(k) < 0.9, "image_hw": (h, w)}
        if mask:
            yy, xx = np.mgrid[:28, :28]
            ell = ((yy - 13.5) / 12) ** 2 + ((xx - 13.5) / 12) ** 2 <= 1
            p["masks"] = np.clip(ell[None] * 0.9 + rng.normal(0, 0.2, (k, 28, 28)), 0, 1).astype(np.float32)
        preds.append(p)
    return preds


@pytest.mark.parametrize("seed", range(3))
def test_box_iou_matrix_identical(seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([(xy := rng.uniform(0, 50, (7, 2))), xy + rng.uniform(-1, 20, (7, 2))], 1)
    b = np.concatenate([(xy := rng.uniform(0, 50, (5, 2))), xy + rng.uniform(0, 20, (5, 2))], 1)
    got, want = ce.box_iou_matrix(a, b), jce.box_iou_matrix(a, b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("seed", range(3))
def test_coco_evaluator_matches_jax(iou_type, seed):
    """Both evaluators fed each package's own conversion of the same
    predictions and gt (synthetic windows with their cells)."""
    ds = pap.synthetic_slide_dataset(seed=seed, num_slides=1, slide_size=128, win_size=64, is_train=False)
    samples = [ds[i] for i in range(len(ds))]
    preds = predictions_for(samples, seed)
    ours = ce.CocoEvaluator((1, 2, 3), iou_type=iou_type, max_dets=20)
    theirs = jce.CocoEvaluator((1, 2, 3), iou_type=iou_type, max_dets=20)
    for s, p in zip(samples, preds):
        for pkg, evaluator in ((paste, ours), (jpaste, theirs)):
            dt = pkg.detections_to_instseg(p["boxes"], p["scores"], p["labels"], p["valid"], p["masks"],
                                           p["image_hw"])
            gt = pkg.gt_to_instseg(s["boxes"], s["labels"], np.ones(len(s["boxes"]), bool), s["masks"])
            evaluator.add_image({c: {"boxes": v.boxes, "scores": v.scores, "masks": v} for c, v in dt.items()},
                                {c: {"boxes": v.boxes, "masks": v} for c, v in gt.items()})
    got, want = ours.summarize(), theirs.summarize()
    assert_close(got, want)
    assert got["AP50"] > 0


@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("seed", range(2))
def test_single_class_voc_eval_matches_jax(use_07, seed):
    rng = np.random.default_rng(seed)
    gts = {i: np.concatenate([(xy := rng.uniform(0, 60, (n, 2))), xy + rng.uniform(4, 30, (n, 2))], 1)
           for i, n in enumerate(rng.integers(0, 5, 6))}
    dts = []
    for i, g in gts.items():
        for b in g:
            if rng.random() < 0.7:
                dts.append((i, float(np.round(rng.random(), 1)), b + rng.uniform(-3, 3, 4)))
        for _ in range(int(rng.integers(0, 3))):
            xy = rng.uniform(0, 60, 2)
            dts.append((i, float(np.round(rng.random(), 1)), np.concatenate([xy, xy + rng.uniform(4, 30, 2)])))
    got, want = ce.voc_eval(dts, gts, 0.5, use_07), jce.voc_eval(dts, gts, 0.5, use_07)
    assert_close(list(got[:2]), list(want[:2]))
    assert_close(got[2], want[2])
    assert_close(ce.voc_ap(got[0], got[1], not use_07), jce.voc_ap(want[0], want[1], not use_07))


def _rand_voc_case(rng, n_images=5, n_classes=3):
    """Predictions and gt of the chainercv evaluator, every fourth gt difficult."""
    preds, gts = [], []
    for _ in range(n_images):
        n_p, n_g = int(rng.integers(0, 8)), int(rng.integers(0, 5))

        def boxes(n):
            xy = rng.uniform(0, 80, (n, 2))
            return np.concatenate([xy, xy + rng.uniform(4, 40, (n, 2))], axis=1).astype(np.float32)

        g = boxes(n_g)
        p = np.concatenate([g[: n_p] + rng.uniform(-3, 3, g[: n_p].shape), boxes(max(n_p - n_g, 0))]).astype(np.float32)
        gl = rng.integers(1, n_classes + 1, n_g).astype(np.int64)
        pl = np.concatenate([gl[: n_p], rng.integers(1, n_classes + 1, max(n_p - n_g, 0))]).astype(np.int64)
        preds.append({"boxes": p, "labels": pl, "scores": np.round(rng.uniform(0, 1, len(p)), 1)})
        gts.append({"boxes": g, "labels": gl, "difficult": np.arange(n_g) % 4 == 3})
    return preds, gts


@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_eval_detection_voc_matches_jax(use_07, seed):
    preds, gts = _rand_voc_case(np.random.default_rng(seed))
    got = ve.eval_detection_voc(preds, gts, 0.5, use_07)
    want = jve.eval_detection_voc(preds, gts, 0.5, use_07)
    assert_close(got, want)
    with pytest.raises(ValueError):
        ve.eval_detection_voc(preds, gts[:-1])


def test_do_voc_evaluation_matches_jax(tmp_path):
    D.write_voc(str(tmp_path / "voc"), seed=3, n_images=5)
    ours = voc.PascalVOCDataset(str(tmp_path / "voc"), "trainval", use_difficult=True)
    theirs = jvoc.PascalVOCDataset(str(tmp_path / "voc"), "trainval", use_difficult=True)
    rng = np.random.default_rng(4)
    preds = []
    for i in range(len(ours)):
        g = ours.get_groundtruth(i)
        k = len(g["boxes"])
        preds.append(None if i == 2 else {"boxes": g["boxes"] + rng.uniform(-4, 4, (k, 4)), "labels": g["labels"],
                                          "scores": np.round(rng.uniform(0, 1, k), 1)})
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    os.makedirs(out_a)
    os.makedirs(out_b)
    got = ve.do_voc_evaluation(ours, preds, str(out_a))
    want = jve.do_voc_evaluation(theirs, preds, str(out_b))
    assert_close(got, want)
    assert (out_a / "result.txt").read_text() == (out_b / "result.txt").read_text()


@pytest.fixture(scope="module")
def coco_pair(tmp_path_factory):
    ann_file, img_dir, _ = D.write_coco(str(tmp_path_factory.mktemp("coco_eval")), seed=7, n_images=4)
    return coco.COCODataset(ann_file, img_dir), jcoco.COCODataset(ann_file, img_dir)


@pytest.mark.parametrize("iou_type", ["segm", "bbox"])
@pytest.mark.parametrize("wrapped", [False, True])
def test_evaluate_coco_matches_jax(coco_pair, iou_type, wrapped):
    """COCO datasets route to ``CocoEvaluator``; a one-member
    ``ConcatDataset`` is unwrapped; an image without a prediction (None)
    is skipped."""
    ours, theirs = coco_pair
    preds = predictions_for([ours[i] for i in range(len(ours))], seed=8)
    preds[1] = None
    if wrapped:
        ours, theirs = concat.ConcatDataset([ours]), jconcat.ConcatDataset([theirs])
    got = ev.evaluate(ours, preds, iou_type=iou_type, max_dets=50)
    want = jev.evaluate(theirs, preds, iou_type=iou_type, max_dets=50)
    assert_close(got, want)
    assert set(got["AP_per_class"]) == {1, 2, 3} and got["AP50"] > 0


def test_evaluate_box_only_predictions_matches_jax(coco_pair):
    """Predictions without masks: each box filled, as the engine pastes a
    box-only model's detections."""
    ours, theirs = coco_pair
    preds = predictions_for([ours[i] for i in range(len(ours))], seed=9, mask=False)
    assert_close(ev.evaluate(ours, preds), jev.evaluate(theirs, preds))


def test_evaluate_voc_matches_jax(tmp_path):
    D.write_voc(str(tmp_path), seed=10, n_images=4)
    ours = voc.PascalVOCDataset(str(tmp_path), "trainval", use_difficult=True)
    theirs = jvoc.PascalVOCDataset(str(tmp_path), "trainval", use_difficult=True)
    preds = predictions_for([ours[i] for i in range(len(ours))], seed=11, mask=False)
    preds[0] = None  # labels: the gt's VOC classes, a third of them swapped, and classes 1-3
    got, want = ev.evaluate(ours, preds), jev.evaluate(theirs, preds)
    assert_close(got, want)
    assert np.isfinite(got["map"])


def test_evaluate_pap_matches_jax():
    kw = dict(seed=12, num_slides=1, slide_size=128, win_size=64, is_train=False)
    ours, theirs = pap.synthetic_slide_dataset(**kw), jpap.synthetic_slide_dataset(**kw)
    preds = predictions_for([ours[i] for i in range(len(ours))], seed=13)
    for p in preds:
        p["labels"] = np.minimum(p["labels"], 2)
    got = ev.evaluate(ours, preds, categories=(1, 2), max_dets=100)
    want = jev.evaluate(theirs, preds, categories=(1, 2), max_dets=100)
    assert_close(got, want)
    assert got["AJI"][1] > 0


def test_evaluate_refuses_other_types(coco_pair):
    ours, _ = coco_pair
    with pytest.raises(NotImplementedError, match="ConcatDataset"):
        ev.evaluate(concat.ConcatDataset([ours, ours]), [])
    with pytest.raises(NotImplementedError, match="object"):
        ev.evaluate(object(), [])
