"""Eval worker: paste and per-image Papeval stats of one image (the port's
copy of ``mmt_psm_tpu/engine/_eval_worker.py``).

``engine/inference.py`` runs ``eval_one`` in a pool of spawned processes:
the per-image host work (paste into image space, then the AJI/F1/DSC/mAP
bookkeeping) is independent across images. This module and what it
imports are numpy and the C++ library only: a worker never imports torch
through it, and never touches the card.
"""

from __future__ import annotations

import time

import numpy as np

from ..evaluation.pap_eval import PapEvaluator
from .paste import detections_to_instseg


def ping() -> float:
    """Makes each worker process start, import this module and load the
    C++ library before the first image arrives; returns the wall-clock
    time it was done (the pool's start, in ``run_inference``'s timing)."""
    from ..evaluation import _native

    _native.library()
    return time.time()


def eval_one(payload):
    """One image: the ImageResult rows the main process's PapEvaluator
    would have appended for it.

    payload: (boxes, scores, labels, valid, masks f16, image_hw,
              gt_by_cat {cat: InstSeg}, converted in the main process so
              the full-frame gt masks never cross the process boundary,
              categories, max_dets, use_iou)
    """
    boxes, scores, labels, valid, masks, image_hw, gt, categories, max_dets, use_iou = payload
    dt = detections_to_instseg(boxes, scores, labels, valid, np.asarray(masks, np.float32), image_hw)
    ev = PapEvaluator(categories=categories, max_dets=max_dets, use_iou=use_iou)
    ev.add_image(dt, gt)
    return ev.results
