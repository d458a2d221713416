"""Fixed-shape greedy NMS over batches of independent problems: a frozen
copy of the program's ``ops/nms.py`` with only its plain sequential scan.
Boxes are sorted by score (stable, so ties keep index order); +1 area,
suppress when IoU >= threshold, invalid rows are never kept and never
suppress.
"""

from __future__ import annotations

import torch

from ..structures.boxes import box_iou
from .topk import top_k

NEG_INF = -1e30


def suppress_plain(boxes_s: torch.Tensor, valid_s: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Greedy suppression flags [P, N] for score-sorted boxes [P, N, 4]."""
    p, n = valid_s.shape
    hit = box_iou(boxes_s, boxes_s) >= thr[:, None, None]  # [P, N, N]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes_s.device).triu(1)
    hit &= later
    supp = torch.zeros(p, n, dtype=torch.bool, device=boxes_s.device)
    for i in range(n):
        alive = ~supp[:, i] & valid_s[:, i]
        supp |= hit[:, i, :] & alive[:, None]
    return supp


def _thresholds(iou_threshold, p: int, device) -> torch.Tensor:
    if isinstance(iou_threshold, torch.Tensor):
        return iou_threshold.to(torch.float32)
    # a fill, not a host->device copy: no sync on the card
    return torch.full((p,), float(iou_threshold), dtype=torch.float32, device=device)


def _nms_mask(boxes, scores, valid, iou_threshold, suppress):
    p = boxes.shape[0]
    order = torch.argsort(-torch.where(valid, scores, NEG_INF), dim=-1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    supp = suppress(boxes_s, valid_s, _thresholds(iou_threshold, p, boxes.device))
    keep_sorted = ~supp & valid_s
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def nms_mask(boxes, scores, valid, iou_threshold) -> torch.Tensor:
    """Exact greedy NMS keep-mask [P, N] in the original box order, by the
    plain sequential scan on any device.

    boxes f32 [P, N, 4] xyxy; scores f32 [P, N]; valid bool [P, N];
    iou_threshold a float or an f32 tensor [P] (one per problem).
    """
    return _nms_mask(boxes, scores, valid, iou_threshold, suppress_plain)


def nms_topk(boxes, scores, valid, iou_threshold, max_out: int):
    """NMS keeping the top ``max_out`` survivors of each problem in score order.

    Returns (indices int64 [P, max_out], valid_out bool [P, max_out]);
    padding slots hold index 0 with valid_out False, as in the JAX
    ``nms_topk``.
    """
    keep = nms_mask(boxes, scores, valid, iou_threshold)
    kept = torch.where(keep, scores, NEG_INF)
    k = min(max_out, boxes.shape[1])
    top_scores, top_idx = top_k(kept, k)
    if k < max_out:
        pad = max_out - k
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=NEG_INF)
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))
    return top_idx, top_scores > NEG_INF / 2
