"""Faster R-CNN box encoding and decoding (port of ``mmt_psm_tpu/ops/box_coder.py``).

+1 width convention, per-coordinate weights, exp clipped at log(1000/16),
and the reference's asymmetric "-1" on x2/y2.
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)
TO_REMOVE = 1.0


def encode(reference_boxes: torch.Tensor, proposals: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode ``reference_boxes`` (targets) against ``proposals``, both
    ``[..., N, 4]`` xyxy -> ``[..., N, 4]`` (dx, dy, dw, dh)."""
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    wx, wy, ww, wh = weights
    # padded zero-size boxes must not give nan/inf
    ex_w, ex_h = ex_w.clamp(min=1e-6), ex_h.clamp(min=1e-6)
    gt_w, gt_h = gt_w.clamp(min=1e-6), gt_h.clamp(min=1e-6)
    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode(rel_codes: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """rel_codes ``[..., N, 4K]`` (K classes interleaved) against boxes
    ``[..., N, 4]``; returns the shape of ``rel_codes``."""
    boxes = boxes.to(rel_codes.dtype)
    widths = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    heights = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = rel_codes[..., 0::4] / wx
    dy = rel_codes[..., 1::4] / wy
    dw = (rel_codes[..., 2::4] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (rel_codes[..., 3::4] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    x1 = pred_cx - 0.5 * pred_w
    y1 = pred_cy - 0.5 * pred_h
    x2 = pred_cx + 0.5 * pred_w - 1.0  # the asymmetric -1 is intentional
    y2 = pred_cy + 0.5 * pred_h - 1.0
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(rel_codes.shape)
