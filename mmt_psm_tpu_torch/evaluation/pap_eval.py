"""Papeval: AJI / F1 / DSC / TPRp / FNRo / FDRo / mAP (the port's copy of
``mmt_psm_tpu/evaluation/pap_eval.py``, after the reference's evaluator,
maskrcnn_benchmark/data/datasets/evaluation/pap/pap_eval.py:212-975):

* per-(image, class) stats from ``iou_int_uni``, DSC = 2I/(U+I+1e-10)
  with the intersection zeroed where iou <= 0 (pap_eval.py:306-329);
* F1: per-gt best-dt matching with duplicate resolution (keep the
  max-IoU gt, search again for the rest), TP at IoU > 0.5, PR lists over
  28 thresholds in [0.2, 0.9] (pap_eval.py:332-423);
* DSC/TPRp/FNRo/FDRo: global greedy matching on the DSC matrix above 0.7
  (pap_eval.py:427-477);
* mAP matches: COCO-style greedy per threshold .5:.05:.95
  (pap_eval.py:480-509), then COCO's accumulate with 101-point precision
  (pap_eval.py:706-796) over a mergesort score order, so ties keep the
  order in which images were added;
* AJI: per-gt greedy best-IoU (>= 0.5) matching that sums I and U, the
  areas of unmatched dt and gt added to U, I/U per image, averaged over
  images (pap_eval.py:573-630);
* summarize: per-class AJI/F1 image means, DSC/TPRp instance means,
  FNRo/FDRo global ratios, mAP/AP50/75/85 (pap_eval.py:799-942).

The greedy matchings run in the C++ library (``_native``); its plain
numpy versions are ``_native.map_matches_plain`` and ``aji_match_plain``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import _native
from .instmask import InstSeg, iou_int_uni

IOU_THRS = np.linspace(0.5, 0.95, 10, endpoint=True)
REC_THRS = np.linspace(0.0, 1.00, 101, endpoint=True)
PR_THREADS = np.linspace(0.2, 0.9, 28)


def compute_pair_stats(dt: InstSeg, gt: InstSeg):
    """(iou, inter, union, gt_area, dsc) per pap_eval.computeIoU:274-329."""
    iou, inter, union = iou_int_uni(dt, gt)
    inter = inter.copy()
    inter[iou <= 0] = 0
    dsc = 2 * inter / (union + inter + 1e-10)
    return iou, inter, union, gt.areas.copy(), dsc


def compute_f1(gt_area, iou, intersection, use_iou=True):
    """Greedy unique gt<->dt matching + PR lists (pap_eval.py:332-423)."""
    iou_list = [list(row) for row in iou.T]  # [G][D]
    inter_index = [row.index(max(row)) if max(row) > 0 else -1 for row in iou_list]
    inter_value = [max(row) for row in iou_list]

    def live_set():
        s = set(inter_index)
        s.discard(-1)
        return s

    s = live_set()
    while (len(inter_index) - inter_value.count(0)) != len(s):
        dup = []
        for v in s:
            if inter_index.count(v) > 1:
                dup = [i for i, x in enumerate(inter_index) if x == v]
                break
        vals = [inter_value[i] for i in dup]
        del dup[vals.index(max(vals))]
        v = inter_index[dup[0]]
        for i in dup:
            iou_list[i][v] = 0
            inter_index[i] = iou_list[i].index(max(iou_list[i])) if max(iou_list[i]) > 0 else -1
            inter_value[i] = max(iou_list[i])
        s = live_set()

    TP = 0
    TPLIST = [0] * 28
    for gtidx, segidx in enumerate(inter_index):
        if segidx != -1:
            if use_iou:
                value = iou_list[gtidx][segidx]
            else:
                value = intersection[gtidx, segidx] / gt_area[gtidx]
            if value > 0.5:
                TP += 1
            for k, thread in enumerate(PR_THREADS):
                if value > thread:
                    TPLIST[k] += 1

    n_dt = iou.shape[0]
    n_gt = len(gt_area)
    FNLIST = [n_gt - t for t in TPLIST]
    FPLIST = [n_dt - t for t in TPLIST]
    PLIST = [t / (t + f) if (t + f) else 0 for t, f in zip(TPLIST, FPLIST)]
    RLIST = [t / (t + f) if (t + f) else 0 for t, f in zip(TPLIST, FNLIST)]
    F1LIST = [2 * p * r / (p + r) if (p + r) else 0 for p, r in zip(PLIST, RLIST)]

    FN = n_gt - TP
    FP = n_dt - TP
    precision = TP / (TP + FP) if (TP + FP) else 0
    recall = TP / (TP + FN) if (TP + FN) else 0
    F1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0
    return PLIST, RLIST, F1, precision, recall, F1LIST


def calculate_metrics(ious, ints, areas, dsc):
    """DSC>0.7 greedy matching -> per-gt dsc/tpr + FNR/FDR counts
    (pap_eval.py:427-477)."""
    dc_thread = 0.7
    if ious is None or ious.size == 0 or ious.shape[0] == 0:
        # reference quirk: with zero detections FNR and FDR are both 0
        # (pap_eval.py:436-445), not G
        return np.array([]), np.array([]), 0, 0

    D, G = ious.shape
    allTPR = ints / np.maximum(areas[None, :], 1e-12)
    gtdsc = np.zeros(G)
    gttpr = np.zeros(G)
    dsc = dsc.copy()
    while dsc.size and dsc.max() > dc_thread:
        ind = np.unravel_index(np.argmax(dsc), dsc.shape)
        gtdsc[ind[1]] = dsc[ind]
        gttpr[ind[1]] = allTPR[ind]
        dsc[ind[0], :] = 0
        dsc[:, ind[1]] = 0
    alldsc = gtdsc[gtdsc > dc_thread]
    alltpr = gttpr[gtdsc > dc_thread]
    FNR = G - np.count_nonzero(gtdsc)
    FDR = D - np.count_nonzero(gtdsc)
    return alldsc, alltpr, FNR, FDR


def cal_map_matches(n_dt, n_gt, ious, thrs=IOU_THRS):
    """COCO-style greedy matching per threshold (pap_eval.py:480-509), in
    the C++ library."""
    if ious is None or np.size(ious) == 0:
        return np.zeros((len(thrs), n_dt)), np.zeros((len(thrs), n_gt))
    return _native.map_matches(ious, np.asarray(thrs, np.float64), n_dt, n_gt)


def compute_aji(dt: InstSeg, gt: InstSeg, ious, inter, union):
    """Per-image AJI (pap_eval.py:573-630), in the C++ library."""
    if ious is None or np.size(ious) == 0:
        return 0.0
    return _native.aji_match(ious, inter, union, dt.areas, gt.areas)


@dataclass
class ImageResult:
    category_id: int
    dt_scores: np.ndarray
    map_dtm: np.ndarray  # [T, D]
    n_gt: int
    n_dt: int
    aji: float
    f1: float
    dsc: np.ndarray  # matched per-gt DSC values
    tpr: np.ndarray
    fnr: int
    fdr: int


class PapEvaluator:
    """Accumulates per-image detections/gt and produces the reference's
    stat dict. Categories are 1-based foreground ids (1 cytoplasm,
    2 nuclei for pap)."""

    def __init__(self, categories=(1, 2), max_dets: int = 200, use_iou: bool = True):
        self.categories = tuple(categories)
        self.max_dets = max_dets
        self.use_iou = use_iou
        self.results: list[ImageResult] = []

    def add_image(self, dt_by_cat: dict, gt_by_cat: dict):
        """dt_by_cat/gt_by_cat: {cat_id: InstSeg}; dt needs scores."""
        for cat in self.categories:
            dt = dt_by_cat.get(cat)
            gt = gt_by_cat.get(cat)
            dt = dt if dt is not None else InstSeg(np.zeros((0, 4)), [], np.zeros(0))
            gt = gt if gt is not None else InstSeg(np.zeros((0, 4)), [])
            if len(dt) == 0 and len(gt) == 0:
                continue  # reference skips (evaluateImg returns None)

            if len(dt) > 0:
                order = np.argsort(-dt.scores, kind="mergesort")[: self.max_dets]
                dt = dt.select(order)

            if len(dt) and len(gt):
                iou, inter, union, gt_area, dsc = compute_pair_stats(dt, gt)
            else:
                iou = np.zeros((len(dt), len(gt)))
                inter = np.zeros_like(iou)
                union = np.zeros_like(iou)
                gt_area = gt.areas.copy()
                dsc = np.zeros_like(iou)

            # F1 block (evaluateImg :560-575 edge cases)
            if len(gt) and len(dt):
                _, _, f1, _, _, _ = compute_f1(gt_area, iou, inter, self.use_iou)
            elif len(gt) == 0 and len(dt) > 0:
                f1 = 1
            elif len(gt) > 0 and len(dt) == 0:
                f1 = 0
            else:
                f1 = 1

            alldsc, alltpr, fnr, fdr = calculate_metrics(iou, inter, gt_area, dsc)

            map_dtm, _ = cal_map_matches(len(dt), len(gt), iou)
            aji = compute_aji(dt, gt, iou, inter, union) if len(dt) and len(gt) else 0.0

            self.results.append(
                ImageResult(
                    category_id=cat,
                    dt_scores=dt.scores if dt.scores is not None else np.zeros(len(dt)),
                    map_dtm=map_dtm,
                    n_gt=len(gt),
                    n_dt=len(dt),
                    aji=aji,
                    f1=f1,
                    dsc=alldsc,
                    tpr=alltpr,
                    fnr=fnr,
                    fdr=fdr,
                )
            )

    # ----------------------------------------------------------- accumulate
    def _accumulate_class(self, cat):
        """COCO 101-point precision per IoU threshold (pap_eval.py:706-796)."""
        E = [r for r in self.results if r.category_id == cat]
        T, R = len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((T, R))
        if not E:
            return precision
        dt_scores = np.concatenate([e.dt_scores for e in E]) if E else np.zeros(0)
        inds = np.argsort(-dt_scores, kind="mergesort")
        dtm = np.concatenate([e.map_dtm for e in E], axis=1)[:, inds]
        npig = sum(e.n_gt for e in E)
        tps = dtm > 0
        fps = dtm == 0
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / npig if npig else tp * 0
            pr = tp / (fp + tp + np.spacing(1))
            q = np.zeros(R)
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds_r = np.searchsorted(rc, REC_THRS, side="left")
            for ri, pi in enumerate(inds_r):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[t] = q
        return precision

    def summarize(self) -> dict:
        stats = {k: {} for k in ["AJI", "F1", "DSC", "TPRP", "FNRo", "FDRo", "mAP", "AP50", "AP75", "AP85"]}
        precisions = {}
        for cat in self.categories:
            precisions[cat] = self._accumulate_class(cat)

        def _ap(prec, iou_thr=None):
            s = prec
            if iou_thr is not None:
                t = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[t]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        for cat in self.categories:
            E = [r for r in self.results if r.category_id == cat]
            if not E:
                continue
            n = len(E)
            stats["AJI"][cat] = float(np.mean([e.aji for e in E]))
            stats["F1"][cat] = float(np.mean([e.f1 for e in E]))
            dsc_all = np.concatenate([e.dsc for e in E]) if E else np.zeros(0)
            tpr_all = np.concatenate([e.tpr for e in E]) if E else np.zeros(0)
            stats["DSC"][cat] = float(dsc_all.sum() / (len(dsc_all) + 1e-10))
            stats["TPRP"][cat] = float(tpr_all.sum() / (len(tpr_all) + 1e-10))
            num_g = sum(e.n_gt for e in E)
            num_d = sum(e.n_dt for e in E)
            stats["FNRo"][cat] = float(sum(e.fnr for e in E) / num_g) if num_g else 0.0
            stats["FDRo"][cat] = float(sum(e.fdr for e in E) / num_d) if num_d else 0.0
            stats["mAP"][cat] = _ap(precisions[cat])
            stats["AP50"][cat] = _ap(precisions[cat], 0.5)
            stats["AP75"][cat] = _ap(precisions[cat], 0.75)
            stats["AP85"][cat] = _ap(precisions[cat], 0.85)

        all_prec = np.stack([precisions[c] for c in self.categories], axis=-1)
        stats["mAP"]["all"] = _ap(all_prec)
        stats["AP50"]["all"] = _ap(all_prec[np.isclose(IOU_THRS, 0.5)])
        stats["AP75"]["all"] = _ap(all_prec[np.isclose(IOU_THRS, 0.75)])
        stats["AP85"]["all"] = _ap(all_prec[np.isclose(IOU_THRS, 0.85)])
        return stats
