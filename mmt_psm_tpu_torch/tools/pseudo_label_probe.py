"""Pseudo-label quality probe of the mean-teacher loop (the port's copy of
``scripts/pseudo_label_probe.py``).

    python -m mmt_psm_tpu_torch.tools.pseudo_label_probe [--iters 400] [--size 256] [--batch 4]
        [--lr 2.5e-4] [--labeled-slides 1] [--out F] [--device cpu]

Trains the supervised warm-up as the lift's arms do (the lift's model and
seeded init, seed-0 slides, LAMBDA 0, no decay inside the warm-up), then
runs the teacher's pseudo-labelling, which is the test-mode forward
(``train/mt_step.py``'s teacher detections), on the lift's held-out
windows, whose gt is known, and reports the detections' precision and
recall at IoU 0.5 with a matching label, the mean score of hits and
misses, and the precision above score thresholds. It answers whether the
pseudo-labels at START_MT were good enough for PSM to help: the first check
when a lift comes back flat (reference engine/MTtrainer.py:247-275). The
loop runs in ``<tmp>/pseudo_probe_run`` (``tempfile.gettempdir()``). The
JSON written to ``--out`` holds the JAX script's keys (on a card also
``card``: its name and power limit). Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

SCORE_THRESHOLDS = (0.05, 0.3, 0.5, 0.7)


def box_iou(a, b):
    """[N, 4] x [M, 4] xyxy IoU matrix."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.clip(area_a[:, None] + area_b[None] - inter, 1e-9, None)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="pseudo-label precision and recall after the supervised warm-up")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--labeled-slides", type=int, default=1)
    ap.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "pseudo_probe.json"))
    ap.add_argument("--device", type=str, default=None, help="torch device; default: the card")
    return ap.parse_args(argv)


def probe_config(args):
    """The warm-up's config: the lift's solver without its decay, no MT."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.SOLVER.BASE_LR = args.lr
    cfg.SOLVER.MAX_ITER = args.iters
    cfg.SOLVER.STEPS = (10 * args.iters,)  # no decay inside the warm-up
    cfg.SOLVER.WARMUP_ITERS = min(100, args.iters // 5)
    cfg.SOLVER.IMS_PER_BATCH = args.batch
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.MT.LAMBDA = 0.0
    return cfg


def score_detections(dets, batch, stats, per_thresh) -> None:
    """Greedy matching of one batch's detections, by score, to unused gt of
    the same label at IoU >= 0.5, added into ``stats`` and ``per_thresh``.
    Every row counts, the test loader's padding repeats too, as in JAX."""
    for i in range(len(batch["image"])):
        v = dets["valid"][i].astype(bool)
        boxes, scores, labels = dets["boxes"][i][v], dets["scores"][i][v], dets["labels"][i][v]
        gv = np.asarray(batch["gt_valid"][i]).astype(bool)
        gboxes = np.asarray(batch["boxes"][i])[gv]
        glabels = np.asarray(batch["labels"][i])[gv]
        stats["n_gt"] += int(gv.sum())
        if len(boxes) == 0:
            continue
        iou = box_iou(boxes, gboxes) if len(gboxes) else np.zeros((len(boxes), 0))
        used = np.zeros(len(gboxes), bool)
        for j in np.argsort(-scores):
            cand = np.flatnonzero((iou[j] >= 0.5) & ~used & (glabels == labels[j])) if len(gboxes) else []
            hit = len(cand) > 0
            if hit:
                used[cand[np.argmax(iou[j][cand])]] = True
                stats["tp"] += 1
                stats["scores_tp"].append(float(scores[j]))
            else:
                stats["fp"] += 1
                stats["scores_fp"].append(float(scores[j]))
            for t in per_thresh:
                if scores[j] >= t:
                    key = "hit" if hit else "miss"
                    per_thresh[t][key] = per_thresh[t].get(key, 0) + 1


def main(argv=None) -> dict:
    from ..data.loader import make_source_loader, make_test_loader
    from ..data.pap import synthetic_slide_dataset
    from ..engine.trainer import MTTrainer
    from ..models.detector import resolve_device
    from .mt_lift_experiment import MAX_GT, arm_steps, build_model, held_out, init_model

    args = parse_args(argv)
    device = resolve_device(args.device)
    size = args.size
    init = init_model(build_model(size)[0], 0).to(device)
    train_ds = synthetic_slide_dataset(seed=0, num_slides=args.labeled_slides, slide_size=2 * size, win_size=size,
                                       overlap=0.5)
    val_ds = held_out(size)
    steps = arm_steps(init, probe_config(args))
    del init
    src = make_source_loader(train_ds, args.batch, size, max_gt=MAX_GT, min_size=size, seed=0)
    out_dir = os.path.join(tempfile.gettempdir(), "pseudo_probe_run")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    loop = MTTrainer(steps, src, None, output_dir=out_dir)
    try:
        loop.train()
    finally:
        loop.source_loader.close()
    print(f"warmup: {args.iters} iters in {time.time() - t0:.0f}s", flush=True)

    # the teacher's pseudo-gt is the test-mode forward: held against known gt
    model = steps.model.eval()
    stats = {"tp": 0, "fp": 0, "n_gt": 0, "scores_tp": [], "scores_fp": []}
    per_thresh = {t: {} for t in SCORE_THRESHOLDS}
    with torch.no_grad():
        for batch in make_test_loader(val_ds, args.batch, size, max_gt=MAX_GT, min_size=size):
            d = model(torch.from_numpy(batch["image"]).to(device), torch.from_numpy(batch["image_size"]).to(device))
            dets = {k: getattr(d, k).float().cpu().numpy() if k != "labels" else getattr(d, k).cpu().numpy()
                    for k in ("boxes", "scores", "labels", "valid")}
            score_detections(dets, batch, stats, per_thresh)

    prec = stats["tp"] / max(stats["tp"] + stats["fp"], 1)
    rec = stats["tp"] / max(stats["n_gt"], 1)
    report = {
        "iters": args.iters,
        "precision": round(prec, 4),
        "recall": round(rec, 4),
        "n_gt": stats["n_gt"],
        "n_det": stats["tp"] + stats["fp"],
        "mean_score_tp": round(float(np.mean(stats["scores_tp"])), 4) if stats["scores_tp"] else 0,
        "mean_score_fp": round(float(np.mean(stats["scores_fp"])), 4) if stats["scores_fp"] else 0,
        "by_score_thresh": {
            str(t): {"precision": round(d.get("hit", 0) / max(d.get("hit", 0) + d.get("miss", 0), 1), 4),
                     "n": d.get("hit", 0) + d.get("miss", 0)}
            for t, d in per_thresh.items()
        },
    }
    if device.type == "cuda":
        from ..utils.env import card_line

        report["card"] = card_line()
    print(json.dumps(report, indent=2))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
