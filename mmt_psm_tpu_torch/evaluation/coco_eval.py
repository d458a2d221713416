"""COCO-style bbox and segm AP (the port's copy of
``mmt_psm_tpu/evaluation/coco_eval.py``, after the reference's upstream
evaluator, maskrcnn_benchmark/data/datasets/evaluation/coco/coco_eval.py,
backed by pycocotools COCOeval): greedy matching per IoU threshold,
101-point interpolated precision, AP / AP50 / AP75 and AP per class, on
the Papeval machinery (the pap evaluator is itself a modified COCOeval,
pap_eval.py:480-509, 706-796). numpy only; the PR curves sort scores with
``np.argsort(kind="mergesort")``, whose ties decide AP.
"""

from __future__ import annotations

import numpy as np

from .instmask import InstSeg, iou_int_uni
from .pap_eval import IOU_THRS, REC_THRS, cal_map_matches


def box_iou_matrix(dt_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Pairwise box IoU in float32 with the +1 convention: the operations
    of ``structures/boxes.py::box_iou``, in its order."""
    a = np.asarray(dt_boxes, np.float32)
    b = np.asarray(gt_boxes, np.float32)
    one = np.float32(1.0)
    area_a = (a[:, 2] - a[:, 0] + one) * (a[:, 3] - a[:, 1] + one)
    area_b = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + one, np.float32(0.0))
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, np.float32(1e-10))


class CocoEvaluator:
    """Accumulates per-image detections and computes AP stats.

    ``add_image(dt, gt)``, each {cat_id: {"boxes": [N, 4], "scores": [N]
    (dt only), "masks": InstSeg (segm)}}; ``iou_type`` "bbox" or "segm".
    """

    def __init__(self, categories, iou_type: str = "bbox", max_dets: int = 100):
        self.categories = tuple(categories)
        self.iou_type = iou_type
        self.max_dets = max_dets
        self.records = []  # (cat, scores [D], dtm [T, D], n_gt)

    def add_image(self, dt_by_cat: dict, gt_by_cat: dict):
        for cat in self.categories:
            dt = dt_by_cat.get(cat)
            gt = gt_by_cat.get(cat)
            n_dt = len(dt["scores"]) if dt else 0
            n_gt = len(gt["boxes"]) if gt else 0
            if n_dt == 0 and n_gt == 0:
                continue
            if n_dt:
                order = np.argsort(-np.asarray(dt["scores"]), kind="mergesort")[: self.max_dets]
                scores = np.asarray(dt["scores"])[order]
            else:
                order, scores = np.zeros(0, np.int64), np.zeros(0)
            if n_dt and n_gt:
                if self.iou_type == "segm":
                    dseg: InstSeg = dt["masks"].select(order)
                    ious, _, _ = iou_int_uni(dseg, gt["masks"])
                else:
                    ious = box_iou_matrix(np.asarray(dt["boxes"])[order], np.asarray(gt["boxes"]))
            else:
                ious = np.zeros((len(order), n_gt))
            dtm, _ = cal_map_matches(len(order), n_gt, ious)
            self.records.append((cat, scores, dtm, n_gt))

    def _precision(self, cat):
        recs = [r for r in self.records if r[0] == cat]
        precision = -np.ones((len(IOU_THRS), len(REC_THRS)))
        if not recs:
            return precision
        scores = np.concatenate([r[1] for r in recs])
        inds = np.argsort(-scores, kind="mergesort")
        dtm = np.concatenate([r[2] for r in recs], axis=1)[:, inds]
        npig = sum(r[3] for r in recs)
        if npig == 0:
            return precision
        tp = np.cumsum(dtm > 0, axis=1).astype(np.float64)
        fp = np.cumsum(dtm == 0, axis=1).astype(np.float64)
        for t in range(len(IOU_THRS)):
            rc = tp[t] / npig
            pr = (tp[t] / (tp[t] + fp[t] + np.spacing(1))).tolist()
            for i in range(len(pr) - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            q = np.zeros(len(REC_THRS))
            for ri, pi in enumerate(np.searchsorted(rc, REC_THRS, side="left")):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precision[t] = q
        return precision

    def summarize(self) -> dict:
        per_cat = {c: self._precision(c) for c in self.categories}
        stack = np.stack([per_cat[c] for c in self.categories], axis=-1)

        def ap(s):
            v = s[s > -1]
            return float(v.mean()) if v.size else -1.0

        return {
            "AP": ap(stack),
            "AP50": ap(stack[np.isclose(IOU_THRS, 0.5)]),
            "AP75": ap(stack[np.isclose(IOU_THRS, 0.75)]),
            "AP_per_class": {c: ap(per_cat[c]) for c in self.categories},
        }


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP of recall and precision curves (the reference's voc_eval.py)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(dt_records, gt_records, iou_thresh: float = 0.5, use_07_metric: bool = False):
    """Single-class VOC detection AP. ``dt_records``: [(image_id, score,
    box [4])]; ``gt_records``: {image_id: [M, 4] boxes}. Returns (recall,
    precision, ap)."""
    npos = sum(len(b) for b in gt_records.values())
    matched = {k: np.zeros(len(v), bool) for k, v in gt_records.items()}
    dt_sorted = sorted(dt_records, key=lambda r: -r[1])
    tp = np.zeros(len(dt_sorted))
    fp = np.zeros(len(dt_sorted))
    for i, (img, _, box) in enumerate(dt_sorted):
        gts = gt_records.get(img, np.zeros((0, 4)))
        if len(gts):
            ious = box_iou_matrix(np.asarray(box, np.float32)[None], np.asarray(gts, np.float32))[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh and not matched[img][j]:
                matched[img][j] = True
                tp[i] = 1
                continue
        fp[i] = 1
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    rec = tp_c / max(npos, 1)
    prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
