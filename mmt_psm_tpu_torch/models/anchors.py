"""FPN anchors (port of ``mmt_psm_tpu/models/anchors.py``).

The classic Faster R-CNN cell-anchor enumeration (maskrcnn_benchmark
rpn/anchor_generator.py) around a (0, 0, stride-1, stride-1) window with
rounded widths and heights, shifted over the feature grid in (y, x,
anchor) order. Images are padded to one square canvas, so the anchors are
a constant per configuration, computed once in numpy.
"""

from __future__ import annotations

import numpy as np


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1), x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])


def generate_cell_anchors(stride, sizes, aspect_ratios) -> np.ndarray:
    scales = np.array(sizes, dtype=np.float64) / stride
    ratios = np.array(aspect_ratios, dtype=np.float64)
    base = np.array([1, 1, stride, stride], dtype=np.float64) - 1
    w, h, x_ctr, y_ctr = _whctrs(base)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)
    out = []
    for a in ratio_anchors:
        w, h, x_ctr, y_ctr = _whctrs(a)
        out.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out).astype(np.float32)


def grid_anchors(cell: np.ndarray, grid: int, stride: int) -> np.ndarray:
    shifts = np.arange(0, grid * stride, stride, dtype=np.float32)
    sx, sy = np.meshgrid(shifts, shifts)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)


def fpn_anchors(image_size: int, strides, sizes, aspect_ratios):
    """Per-level float32 [H_l*W_l*A, 4] anchors, one size per stride."""
    return [
        grid_anchors(generate_cell_anchors(stride, (size,), aspect_ratios), image_size // stride, stride)
        for stride, size in zip(strides, sizes)
    ]


def visibility(anchors, image_h, image_w, straddle_thresh: float = 0.0):
    """Anchors inside the image by ``straddle_thresh`` (all of them when it
    is negative). anchors [..., 4]; image_h/image_w broadcast against
    ``anchors[..., 0]``."""
    if straddle_thresh < 0:
        return anchors[..., 0] == anchors[..., 0]
    return (
        (anchors[..., 0] >= -straddle_thresh)
        & (anchors[..., 1] >= -straddle_thresh)
        & (anchors[..., 2] < image_w + straddle_thresh)
        & (anchors[..., 3] < image_h + straddle_thresh)
    )
