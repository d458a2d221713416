"""Faster R-CNN box decoding (port of ``mmt_psm_tpu/ops/box_coder.py``).

+1 width convention, per-coordinate weights, exp clipped at log(1000/16),
and the reference's asymmetric "-1" on x2/y2.
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)
TO_REMOVE = 1.0


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
