"""COCO-format dataset: a JSON of annotations beside the image files (the
port's copy of ``mmt_psm_tpu/data/coco.py``, after the reference's
COCODataset, maskrcnn_benchmark/data/datasets/coco.py), on the ``CELL``
index. It yields the sample dict of ``PapDataset`` (image, boxes, labels,
full-frame instance masks), so the loaders and evaluators take it as they
are.

Crowd annotations and boxes with a width or height <= 0 are dropped; a
box is [x, y, x + w - 1, y + h - 1]; categories map to contiguous labels
from 1 in the order of their ids. A segmentation is a polygon list
(rasterized by PIL's ``ImageDraw.polygon``, edges inclusive), an
uncompressed RLE dict (the C++ library's column-major decoder) or absent
(the box filled).
"""

from __future__ import annotations

import os

import numpy as np

from .cell import CELL


def rasterize_polygons(polys, h: int, w: int) -> np.ndarray:
    """COCO polygon list -> bool mask [h, w]."""
    from PIL import Image, ImageDraw

    img = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, bool)


class COCODataset:
    def __init__(self, ann_file, root: str, remove_images_without_annotations: bool = True):
        self.coco = CELL(ann_file)
        self.root = root
        ids = sorted(self.coco.imgs)
        if remove_images_without_annotations:
            ids = [i for i in ids if self.coco.getAnnIds(imgIds=i)]
        self.ids = ids
        self.json_category_id_to_contiguous_id = {v: i + 1 for i, v in enumerate(sorted(self.coco.getCatIds()))}

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index):
        return self.coco.imgs[self.ids[index]]

    def __getitem__(self, index) -> dict:
        from PIL import Image

        from ..evaluation._native import rle_decode

        img_id = self.ids[index]
        info = self.coco.imgs[img_id]
        h, w = info["height"], info["width"]
        image = np.asarray(Image.open(os.path.join(self.root, info["file_name"])).convert("RGB"))
        anns = [a for a in self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id)) if not a.get("iscrowd", 0)]
        boxes, labels, masks = [], [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            if bw <= 0 or bh <= 0:
                continue
            boxes.append([x, y, x + bw - 1, y + bh - 1])
            labels.append(self.json_category_id_to_contiguous_id[a["category_id"]])
            seg = a.get("segmentation")
            if isinstance(seg, list):
                masks.append(rasterize_polygons(seg, h, w))
            elif isinstance(seg, dict):  # uncompressed RLE
                masks.append(rle_decode(np.asarray(seg["counts"], np.int64), h, w).astype(bool))
            else:
                m = np.zeros((h, w), bool)
                x1, y1, x2, y2 = [int(round(v)) for v in boxes[-1]]
                m[y1 : y2 + 1, x1 : x2 + 1] = True
                masks.append(m)
        return {
            "image": image,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "masks": np.stack(masks).astype(np.uint8) if masks else np.zeros((0, h, w), np.uint8),
        }
