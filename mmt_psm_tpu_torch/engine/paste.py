"""Host-side mask pasting and InstSeg conversion (the port's copy of
``mmt_psm_tpu/engine/paste.py``; numpy and the C++ library, no torch), so
the eval workers (``engine/_eval_worker.py``) import it without torch.
The paste follows the reference Masker (mask_head/inference.py:169-246).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..evaluation import _native
from ..evaluation.instmask import InstSeg


def _bilinear_resize(img, out_h, out_w):
    """2-D bilinear resize, align_corners=False (torch F.interpolate
    semantics: src = (dst+0.5)*in/out - 0.5, clamped into [0, in-1])."""
    in_h, in_w = img.shape
    ys = np.clip((np.arange(out_h) + 0.5) * in_h / out_h - 0.5, 0, in_h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * in_w / out_w - 0.5, 0, in_w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = (ys - y0).astype(img.dtype)
    fx = (xs - x0).astype(img.dtype)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def paste_mask_crop(mask_prob, box, im_h, im_w, threshold=0.5, padding=1):
    """Reference-exact Masker paste (mask_head/inference.py:169-206):
    zero-pad the MxM map by 1 px, expand the box by (M+2)/M about its
    center, truncate to int32, bilinear-resize the padded map to the
    +1-convention box extent, threshold STRICTLY at 0.5, and clip to the
    image. Returns (local bitmask, [x0, y0, x1, y1] int box) or None.

    The resize runs in the C++ library (``_native.paste_resize_threshold``,
    over the image-clipped window only; its plain version is the numpy
    ``_bilinear_resize`` of the padded map)."""
    m = mask_prob.shape[-1]
    scale = (m + 2.0 * padding) / m
    w_half = (box[2] - box[0]) * 0.5 * scale
    h_half = (box[3] - box[1]) * 0.5 * scale
    cx = (box[2] + box[0]) * 0.5
    cy = (box[3] + box[1]) * 0.5
    # int32 cast truncates toward zero, matching torch .to(torch.int32)
    bx = np.array([cx - w_half, cy - h_half, cx + w_half, cy + h_half]).astype(np.int32)
    bw = max(int(bx[2] - bx[0] + 1), 1)
    bh = max(int(bx[3] - bx[1] + 1), 1)
    x0, y0 = max(int(bx[0]), 0), max(int(bx[1]), 0)
    x1, y1 = min(int(bx[2]) + 1, im_w), min(int(bx[3]) + 1, im_h)
    if x1 <= x0 or y1 <= y0:
        return None
    crop = _native.paste_resize_threshold(
        np.asarray(mask_prob, np.float32), padding, bh, bw,
        y0 - int(bx[1]), y1 - int(bx[1]), x0 - int(bx[0]), x1 - int(bx[0]),
        threshold,
    )
    return crop, (x0, y0, x1 - 1, y1 - 1)


def detections_to_instseg(boxes, scores, labels, valid, mask_probs, image_hw, threshold=0.5):
    """Convert one image's padded detections into per-class InstSeg.

    boxes/scores/labels/valid/mask_probs: numpy arrays for one image
    ([K,4], [K], [K], [K], [K,M,M]).
    """
    h, w = int(image_hw[0]), int(image_hw[1])
    out = defaultdict(lambda: {"boxes": [], "masks": [], "scores": []})
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        pasted = paste_mask_crop(mask_probs[k], boxes[k], h, w, threshold)
        if pasted is None:
            continue
        local, ibox = pasted
        if not local.any():
            continue
        cat = int(labels[k])
        out[cat]["boxes"].append(list(ibox))
        out[cat]["masks"].append(local)
        out[cat]["scores"].append(float(scores[k]))
    return {
        cat: InstSeg(
            boxes=np.asarray(v["boxes"], np.int64),
            masks=v["masks"],
            scores=np.asarray(v["scores"], np.float64),
        )
        for cat, v in out.items()
    }


def gt_to_instseg(boxes, labels, valid, masks, mask_scale=1.0):
    """Ground truth arrays -> per-class InstSeg. masks: [M, Hm, Wm] full-
    frame bitmasks (possibly at reduced resolution; mask_scale upsamples
    boxes accordingly is NOT applied — pass full-res masks for eval).

    The annotation boxes pre-localize each instance so the tight-bbox
    scan runs on a small padded crop instead of the full frame
    (60 full-frame np.nonzero scans cost ~150 ms/image)."""
    out = defaultdict(lambda: {"boxes": [], "masks": []})
    hm, wm = masks.shape[-2:]
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        bx = boxes[k]
        # pad generously: resize rounding can push mask pixels a few px
        # outside the stored box
        cx1 = max(int(np.floor(bx[0])) - 4, 0)
        cy1 = max(int(np.floor(bx[1])) - 4, 0)
        cx2 = min(int(np.ceil(bx[2])) + 5, wm)
        cy2 = min(int(np.ceil(bx[3])) + 5, hm)
        crop = masks[k, cy1:cy2, cx1:cx2]
        # cheap exactness check: count_nonzero is a SIMD scan without
        # index materialization; mismatch -> box/mask disagree, rescan
        if np.count_nonzero(crop) != np.count_nonzero(masks[k]):
            cy1 = cx1 = 0
            crop = masks[k]
        ys, xs = np.nonzero(crop)
        if len(ys) == 0:
            continue
        y1, y2, x1, x2 = ys.min(), ys.max(), xs.min(), xs.max()
        out[int(labels[k])]["boxes"].append([cx1 + x1, cy1 + y1, cx1 + x2, cy1 + y2])
        out[int(labels[k])]["masks"].append(
            np.ascontiguousarray(crop[y1 : y2 + 1, x1 : x2 + 1]).astype(bool)
        )
    return {
        cat: InstSeg(boxes=np.asarray(v["boxes"], np.int64), masks=v["masks"])
        for cat, v in out.items()
    }


