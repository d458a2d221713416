"""Dataset-level evaluation, by dataset type (the port's copy of
``mmt_psm_tpu/evaluation/dispatch.py``, after the reference's isinstance
dispatch, maskrcnn_benchmark/data/datasets/evaluation/__init__.py:7-32):
``COCODataset`` -> COCO-style AP, ``PascalVOCDataset`` -> VOC 11-point mAP,
the Pap datasets -> Papeval; a ``ConcatDataset`` of one dataset is
unwrapped. ``predictions[i]`` is one image's dict of arrays:
{"boxes" [K, 4], "scores" [K], "labels" [K], "valid" [K],
"masks" [K, R, R] probabilities (optional), "image_hw" (h, w)}.
numpy only: the datasets and the paste load at first use.
"""

from __future__ import annotations

import numpy as np


def _per_cat(prediction, sample):
    """One image's prediction and dataset sample -> (dt, gt) per class."""
    from ..engine.paste import detections_to_instseg, gt_to_instseg

    masks = prediction.get("masks")
    if masks is None:
        # box-only: each box filled, through 1x1 probabilities
        masks = np.ones((len(prediction["boxes"]), 1, 1), np.float32)
    dt = detections_to_instseg(np.asarray(prediction["boxes"]), np.asarray(prediction["scores"]),
                               np.asarray(prediction["labels"]), np.asarray(prediction["valid"]),
                               np.asarray(masks), tuple(prediction["image_hw"]))
    gt = gt_to_instseg(np.asarray(sample["boxes"]), np.asarray(sample["labels"]),
                       np.ones(len(sample["boxes"]), bool), np.asarray(sample["masks"]))
    return dt, gt


def evaluate(dataset, predictions, output_folder: str | None = None, iou_type: str = "segm", **kwargs):
    """Evaluate ``predictions`` (one entry per item of ``dataset``, None
    for an image without one) by the evaluator of the dataset's type."""
    from ..data.coco import COCODataset
    from ..data.concat import ConcatDataset
    from ..data.pap import PapDataset, PapUnlabeledDataset
    from ..data.voc import PascalVOCDataset

    if isinstance(dataset, ConcatDataset) and len(dataset.datasets) == 1:
        dataset = dataset.datasets[0]

    if isinstance(dataset, PascalVOCDataset):
        from .voc_eval import do_voc_evaluation

        preds = []
        for p in predictions:
            if p is None:
                preds.append({"boxes": np.zeros((0, 4)), "labels": np.zeros(0, np.int64), "scores": np.zeros(0)})
                continue
            v = np.asarray(p["valid"], bool)
            preds.append({k: np.asarray(p[k])[v] for k in ("boxes", "labels", "scores")})
        return do_voc_evaluation(dataset, preds, output_folder, kwargs.get("logger"))

    if isinstance(dataset, COCODataset):
        from .coco_eval import CocoEvaluator

        cats = sorted(dataset.json_category_id_to_contiguous_id.values())
        ev = CocoEvaluator(categories=cats, iou_type=iou_type, max_dets=kwargs.get("max_dets", 100))
        for i, p in enumerate(predictions):
            if p is None:
                continue
            dt, gt = _per_cat(p, dataset[i])
            if iou_type == "segm":
                dt = {c: {"boxes": s.boxes, "scores": s.scores, "masks": s} for c, s in dt.items()}
                gt = {c: {"boxes": s.boxes, "masks": s} for c, s in gt.items()}
            else:
                dt = {c: {"boxes": s.boxes, "scores": s.scores} for c, s in dt.items()}
                gt = {c: {"boxes": s.boxes} for c, s in gt.items()}
            ev.add_image(dt, gt)
        return ev.summarize()

    if isinstance(dataset, (PapDataset, PapUnlabeledDataset)):
        from .pap_eval import PapEvaluator

        ev = PapEvaluator(categories=kwargs.get("categories", (1, 2)), max_dets=kwargs.get("max_dets", 200))
        for i, p in enumerate(predictions):
            if p is None:
                continue
            ev.add_image(*_per_cat(p, dataset[i]))
        return ev.summarize()

    raise NotImplementedError(f"Unsupported dataset type {dataset.__class__.__name__}.")
