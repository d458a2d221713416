"""Host-side NMS variants in numpy (port of ``mmt_psm_tpu/ops/python_nms.py``,
after the reference's modeling/python_nms.py).

* ``cyto_nms``: nucleus-id suppression of cytoplasm candidates: in score
  order each kept detection claims one unclaimed nucleus id, and a
  detection whose nuclei are all claimed is dropped;
* ``set_cpu_nms``: set-NMS for K_HEAD > 1: an overlapping box survives when
  the higher-scored box it overlaps came from the same head (proposal);
* ``cpu_nms``: plain greedy NMS without the +1 convention.
"""

from __future__ import annotations

import numpy as np


def _overlap(boxes, basement, others, eps=1e-8):
    x1, y1, x2, y2 = boxes[basement]
    area_b = (x2 - x1) * (y2 - y1)
    o = boxes[others]
    area_o = (o[:, 2] - o[:, 0]) * (o[:, 3] - o[:, 1])
    xx1 = np.maximum(x1, o[:, 0])
    yy1 = np.maximum(y1, o[:, 1])
    xx2 = np.minimum(x2, o[:, 2])
    yy2 = np.minimum(y2, o[:, 3])
    inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
    return inter / (area_b + area_o - inter + eps)


def cyto_nms(boxes, scores, nuclei_id_lists, nms_thresh=0.5):
    """Kept indices into the input order. nuclei_id_lists: each box's list
    of the nucleus ids it contains."""
    if nms_thresh <= 0:
        return np.arange(len(boxes))
    order = np.argsort(-np.asarray(scores), kind="stable")
    id_lists = [list(nuclei_id_lists[i]) for i in order]
    keep_sorted = []
    assigned = []
    start = None
    for i in range(len(order)):
        if id_lists[i]:
            keep_sorted.append(i)
            assigned.append(id_lists[i][0])
            start = i
            break
    if start is None:
        return np.array([], np.int64)
    for j in range(start + 1, len(order)):
        ids = id_lists[j]
        for nucleus in assigned:
            while nucleus in ids:
                ids.remove(nucleus)
        if ids:
            assigned.append(ids[0])
            keep_sorted.append(j)
    return order[np.asarray(keep_sorted, np.int64)]


def set_cpu_nms(boxes, scores, head_ids, nms_thresh=0.5):
    """Set-NMS keep mask in the input order: a box is suppressed unless the
    overlapping higher-scored box came from the same head."""
    if nms_thresh <= 0:
        return np.ones(len(boxes), bool)
    boxes = np.asarray(boxes, np.float64)
    order = np.argsort(-np.asarray(scores), kind="stable")
    dets = boxes[order]
    numbers = np.asarray(head_ids)[order]

    keep = np.ones(len(dets), bool)
    ruler = np.arange(len(dets))
    while ruler.size > 0:
        basement = ruler[0]
        ruler = ruler[1:]
        num = numbers[basement]
        overlap = _overlap(dets, basement, ruler)
        indices = np.where(overlap > nms_thresh)[0]
        loc = np.where(numbers[ruler][indices] == num)[0]
        mask = keep[ruler[indices][loc]].copy()
        keep[ruler[indices]] = False
        keep[ruler[indices][loc][mask]] = True
        ruler = ruler[keep[ruler]]
    out = np.zeros(len(dets), bool)
    out[order] = keep
    return out


def cpu_nms(dets, base_thr):
    """Greedy NMS over [N, 5] (x1, y1, x2, y2, score) without the +1
    convention. Returns the kept indices in score order."""
    dets = np.asarray(dets, np.float64)
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1) * (y2 - y1)
    order = np.argsort(-scores)
    keep = []
    eps = 1e-8
    while len(order) > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter + eps)
        order = order[np.where(ovr <= base_thr)[0] + 1]
    return np.asarray(keep)
