"""Instance masks stored box-cropped, and their pairwise IoU,
intersection and union (the port's copy of
``mmt_psm_tpu/evaluation/instmask.py``).

The reference scores masks through a patched pycocotools whose
``iouIntUni`` returns (iou, intersection, union) per (dt, gt) pair
(pycoco/_mask.pyx:318-397); AJI needs the raw sums. Here each mask is
its integer box plus the box-local boolean array, and a pair is counted
on the intersection of the two boxes, which gives the same numbers as
the full-frame RLE count in O(overlap) instead of O(image).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import _native


@dataclass
class InstSeg:
    """A set of instance masks. boxes are integer xyxy (inclusive), each
    mask is the box-local boolean array of shape (y2-y1+1, x2-x1+1)."""

    boxes: np.ndarray  # i64 [N, 4]
    masks: List[np.ndarray]  # N box-local bool arrays
    scores: np.ndarray | None = None  # f64 [N]
    areas: np.ndarray = field(init=False)

    def __post_init__(self):
        self.boxes = np.asarray(self.boxes, np.int64).reshape(-1, 4)
        self.areas = np.array([m.sum() for m in self.masks], np.float64)
        if self.scores is not None:
            self.scores = np.asarray(self.scores, np.float64)

    def __len__(self):
        return len(self.masks)

    @classmethod
    def from_full_masks(cls, full_masks, scores=None):
        """Build from full-frame boolean masks [N, H, W]."""
        boxes, local = [], []
        for m in full_masks:
            ys, xs = np.nonzero(m)
            if len(ys) == 0:
                boxes.append([0, 0, 0, 0])
                local.append(np.zeros((1, 1), bool))
            else:
                y1, y2, x1, x2 = ys.min(), ys.max(), xs.min(), xs.max()
                boxes.append([x1, y1, x2, y2])
                local.append(np.ascontiguousarray(m[y1 : y2 + 1, x1 : x2 + 1]))
        return cls(
            boxes=np.asarray(boxes, np.int64),
            masks=local,
            scores=np.asarray(scores, np.float64)[: len(local)] if scores is not None else None,
        )

    def select(self, idx):
        return InstSeg(
            boxes=self.boxes[idx],
            masks=[self.masks[i] for i in idx],
            scores=self.scores[idx] if self.scores is not None else None,
        )


def iou_int_uni(dt: InstSeg, gt: InstSeg):
    """(iou, intersection, union) matrices [D, G], float64: the contract of
    the reference's ``maskUtils.iouIntUni`` for non-crowd gt. The
    intersections come from the C++ library."""
    d, g = len(dt), len(gt)
    if d and g:
        inter = _native.pair_intersections(dt.masks, dt.boxes, gt.masks, gt.boxes).astype(np.float64)
    else:
        inter = np.zeros((d, g), np.float64)
    union = dt.areas[:, None] + gt.areas[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    return iou, inter, union
