"""Segmentation formats: polygon <-> bitmask <-> RLE (the port's copy of
``mmt_psm_tpu/utils/segms.py``, after the reference's conversions,
maskrcnn_benchmark/utils/miscellaneous.py:60-231, structures/
segmentation_mask.py:127-137, and the contour extraction of tools/
cityscapes/instances2dict_with_polygons.py). Polygons rasterize through
PIL, contours come from OpenCV (imported where a contour is taken), RLE
is the C++ library's column-major codec (pycocotools semantics).
"""

from __future__ import annotations

import numpy as np


def polys_to_mask(polys, height: int, width: int) -> np.ndarray:
    """COCO polygon list -> bool [H, W] (segmentation_mask.py:127-137)."""
    from ..data.coco import rasterize_polygons

    return rasterize_polygons(polys, height, width)


def mask_to_polygons(mask: np.ndarray) -> list:
    """bool/u8 [H, W] -> list of flat [x0, y0, x1, y1, ...] polygons, the
    outer contours of at least 3 points (instances2dict_with_polygons.py:
    40-79). Needs OpenCV (``cv2``)."""
    import cv2

    m = np.ascontiguousarray(mask, np.uint8)
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    polys = []
    for c in contours:
        c = c.reshape(-1, 2)
        if len(c) >= 3:
            polys.append(c.reshape(-1).astype(np.float64).tolist())
    return polys


def mask_to_rle(mask: np.ndarray) -> dict:
    """bool/u8 [H, W] -> uncompressed COCO RLE dict."""
    from ..evaluation._native import rle_encode

    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": [int(c) for c in rle_encode(mask)]}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Uncompressed COCO RLE dict -> u8 [H, W]."""
    from ..evaluation._native import rle_decode

    h, w = rle["size"]
    return rle_decode(np.asarray(rle["counts"], np.int64), h, w)


def polys_to_boxes(polys_list) -> np.ndarray:
    """Each instance's polygon list -> [N, 4] xyxy boxes, the extremes of
    its points (detectron's segms util, as the converter uses it)."""
    boxes = np.zeros((len(polys_list), 4), np.float64)
    for i, polys in enumerate(polys_list):
        pts = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for p in polys])
        boxes[i] = [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
    return boxes


def instances_to_dict_with_polygons(instance_id_image: np.ndarray, id_to_name) -> dict:
    """Cityscapes instanceIds image -> {class name: [{id, contours,
    pixelCount}, ...]} (instances2dict_with_polygons.py:26-64). A pixel
    value < 1000 is a class label without instances, skipped; >= 1000 is
    class_id * 1000 + instance index (convert_cityscapes_to_coco.py:94-98)."""
    out = {}
    img = np.asarray(instance_id_image)
    for inst_id in np.unique(img):
        if inst_id < 1000:
            continue
        name = id_to_name.get(int(inst_id) // 1000)
        if name is None:
            continue
        mask = img == inst_id
        out.setdefault(name, []).append(
            {"id": int(inst_id), "contours": mask_to_polygons(mask), "pixelCount": int(mask.sum())})
    return out
