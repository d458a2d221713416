"""Pascal VOC detection evaluation, chainercv style (the port's copy of
``mmt_psm_tpu/evaluation/voc_eval.py``, after the reference's
maskrcnn_benchmark/data/datasets/evaluation/voc/voc_eval.py:49-217), with
its quirks kept:

* boxes take the integer VOC convention: +1 on x2/y2 before an IoU that
  itself adds 1 to widths (voc_eval.py:108-117);
* each prediction takes its best gt; a second match to that gt is a false
  positive even above the threshold, and a match to a ``difficult`` gt
  counts neither way (voc_eval.py:118-136);
* ``do_voc_evaluation`` scores with the 11-point 2007 metric
  (voc_eval.py:28-33).

Predictions and ground truths are dicts of arrays:
  pred: {"boxes" [N, 4] xyxy, "labels" [N], "scores" [N]}
  gt:   {"boxes" [M, 4], "labels" [M], "difficult" [M] (optional)}
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np


def _voc_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU with +1 widths (boxlist_ops.py:57-92)."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def calc_detection_voc_prec_rec(gt_list, pred_list, iou_thresh: float = 0.5):
    """Precision and recall curves per class (voc_eval.py:70-160)."""
    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)
    for gt, pred in zip(gt_list, pred_list):
        pred_bbox = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        pred_label = np.asarray(pred["labels"], np.int64).reshape(-1)
        pred_score = np.asarray(pred["scores"], np.float64).reshape(-1)
        gt_bbox = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_label = np.asarray(gt["labels"], np.int64).reshape(-1)
        gt_difficult = np.asarray(gt.get("difficult", np.zeros(len(gt_bbox), bool)), bool).reshape(-1)

        for lab in np.unique(np.concatenate((pred_label, gt_label)).astype(int)):
            pred_mask_l = pred_label == lab
            order = pred_score[pred_mask_l].argsort()[::-1]
            pred_bbox_l = pred_bbox[pred_mask_l][order]
            pred_score_l = pred_score[pred_mask_l][order]
            gt_mask_l = gt_label == lab
            gt_bbox_l = gt_bbox[gt_mask_l]
            gt_difficult_l = gt_difficult[gt_mask_l]

            n_pos[lab] += int(np.logical_not(gt_difficult_l).sum())
            score[lab].extend(pred_score_l)
            if len(pred_bbox_l) == 0:
                continue
            if len(gt_bbox_l) == 0:
                match[lab].extend((0,) * pred_bbox_l.shape[0])
                continue

            # the integer box convention (voc_eval.py:108-112)
            pred_bbox_l = pred_bbox_l.copy()
            pred_bbox_l[:, 2:] += 1
            gt_bbox_l = gt_bbox_l.copy()
            gt_bbox_l[:, 2:] += 1
            iou = _voc_iou(pred_bbox_l, gt_bbox_l)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            selec = np.zeros(gt_bbox_l.shape[0], bool)
            for gt_idx in gt_index:
                if gt_idx >= 0:
                    if gt_difficult_l[gt_idx]:
                        match[lab].append(-1)
                    else:
                        match[lab].append(1 if not selec[gt_idx] else 0)
                    selec[gt_idx] = True
                else:
                    match[lab].append(0)

    n_fg_class = max(n_pos.keys()) + 1
    prec = [None] * n_fg_class
    rec = [None] * n_fg_class
    for lab in n_pos.keys():
        score_l = np.array(score[lab])
        match_l = np.array(match[lab], np.int8)[score_l.argsort()[::-1]]
        tp = np.cumsum(match_l == 1)
        fp = np.cumsum(match_l == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[lab] = tp / (fp + tp)
        if n_pos[lab] > 0:
            rec[lab] = tp / n_pos[lab]
    return prec, rec


def calc_detection_voc_ap(prec, rec, use_07_metric: bool = False) -> np.ndarray:
    """AP per class of the PR curves (voc_eval.py:163-217)."""
    ap = np.empty(len(prec))
    for lab in range(len(prec)):
        if prec[lab] is None or rec[lab] is None:
            ap[lab] = np.nan
            continue
        if use_07_metric:
            ap[lab] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                p = 0.0 if np.sum(rec[lab] >= t) == 0 else np.max(np.nan_to_num(prec[lab])[rec[lab] >= t])
                ap[lab] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[lab]), [0]))
            mrec = np.concatenate(([0], rec[lab], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[lab] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def eval_detection_voc(pred_list, gt_list, iou_thresh: float = 0.5, use_07_metric: bool = False) -> dict:
    """{"ap": AP per class, "map": their mean over the defined ones}."""
    if len(gt_list) != len(pred_list):
        raise ValueError(f"{len(gt_list)} ground truths but {len(pred_list)} predictions")
    prec, rec = calc_detection_voc_prec_rec(gt_list, pred_list, iou_thresh)
    ap = calc_detection_voc_ap(prec, rec, use_07_metric=use_07_metric)
    return {"ap": ap, "map": float(np.nanmean(ap))}


def do_voc_evaluation(dataset, predictions, output_folder: str | None = None, logger=None) -> dict:
    """The reference's entry point (voc_eval.py:12-46): ``predictions[i]``
    (a pred dict in image coordinates) against
    ``dataset.get_groundtruth(i)`` with the 2007 11-point metric, images
    without a prediction skipped; writes result.txt into
    ``output_folder``."""
    pred_list, gt_list = [], []
    for image_id, prediction in enumerate(predictions):
        if prediction is None or len(prediction["boxes"]) == 0:
            continue
        pred_list.append(prediction)
        gt_list.append(dataset.get_groundtruth(image_id))
    result = eval_detection_voc(pred_list, gt_list, iou_thresh=0.5, use_07_metric=True)
    result_str = "mAP: {:.4f}\n".format(result["map"])
    for i, ap in enumerate(result["ap"]):
        if i == 0:
            continue
        result_str += "{:<16}: {:.4f}\n".format(dataset.map_class_id_to_class_name(i), ap)
    if logger is not None:
        logger.info(result_str)
    if output_folder:
        with open(os.path.join(output_folder, "result.txt"), "w") as fid:
            fid.write(result_str)
    return result
