"""Prediction overlays and instance label maps, numpy (the port's copy of
``mmt_psm_tpu/utils/visual.py``, in place of the reference's utils/
visual.py display_instance / vis_bbox, which import a module the
reference does not ship, visual.py:7): translucent instance masks in
their class's colour and box outlines over an RGB uint8 image.
"""

from __future__ import annotations

import numpy as np

_PALETTE = np.array(
    [
        [0, 0, 0],
        [66, 133, 244],  # class 1 cytoplasm: blue
        [219, 68, 55],  # class 2 nuclei: red
        [244, 180, 0],
        [15, 157, 88],
    ],
    np.float32,
)


def overlay_instances(image_rgb: np.ndarray, pred: dict, alpha: float = 0.45) -> np.ndarray:
    """``pred``: ``CellDemo.compute_prediction``'s dict, or {"masks":
    per-class InstSeg} alone; boxes and labels, where given, are outlined."""
    out = image_rgb.astype(np.float32).copy()
    for cat, inst in pred.get("masks", {}).items():
        color = _PALETTE[cat % len(_PALETTE)]
        for i in range(len(inst)):
            x1, y1, x2, y2 = inst.boxes[i]
            m = inst.masks[i]
            region = out[y1 : y2 + 1, x1 : x2 + 1]
            region[m] = (1 - alpha) * region[m] + alpha * color
    for box, label in zip(pred.get("boxes", []), pred.get("labels", [])):
        color = _PALETTE[int(label) % len(_PALETTE)]
        x1, y1, x2, y2 = [int(round(v)) for v in box]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2 = min(x2, out.shape[1] - 1)
        y2 = min(y2, out.shape[0] - 1)
        out[y1 : y2 + 1, [x1, x2]] = color
        out[[y1, y2], x1 : x2 + 1] = color
    return np.clip(out, 0, 255).astype(np.uint8)


def instances_to_label_map(inst_by_cat: dict, h: int, w: int) -> np.ndarray:
    """One instance id a pixel (the reference's get_mat_output map,
    utils/get_mat_output.py): 0 background, then 1..N by class, then by
    instance; a later instance overwrites an earlier one."""
    out = np.zeros((h, w), np.int32)
    next_id = 1
    for cat in sorted(inst_by_cat):
        inst = inst_by_cat[cat]
        for i in range(len(inst)):
            x1, y1, x2, y2 = inst.boxes[i]
            region = out[y1 : y2 + 1, x1 : x2 + 1]
            region[inst.masks[i]] = next_id
            next_id += 1
    return out
