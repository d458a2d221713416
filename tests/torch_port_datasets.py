"""Datasets on disk for the port's dataset, evaluator and render tests
(tests/test_torch_port_{datasets,coco_voc_eval,render_utils,datasets_slice}.py),
made from a seed with numpy: a COCO-format split and a Pascal VOC split.

The COCO split mixes every annotation kind the reader takes: polygons,
uncompressed RLE (column-major, so non-square masks), box-only, crowd
and degenerate boxes (w or h <= 0), over categories with ids 7 and 9 (and
a third, 3, used by no annotation in some images), plus one image without
annotations.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mmt_psm_tpu_torch.evaluation._native import rle_encode_plain

CATEGORIES = [{"id": 7, "name": "cytoplasm", "supercategory": "cell"},
              {"id": 9, "name": "nuclei", "supercategory": "cell"},
              {"id": 3, "name": "debris", "supercategory": "other"}]
VOC_NAMES = ("dog", "cat", "person")

VOC_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>
"""
OBJ_XML = """<object>
    <name>{name}</name><difficult>{difficult}</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""


def _blob(rng, h, w):
    """A random filled ellipse: (mask u8 [h, w], xywh box of its pixels)."""
    cy, cx = rng.uniform(0.25, 0.75) * h, rng.uniform(0.25, 0.75) * w
    ry, rx = rng.uniform(2.5, h / 4), rng.uniform(2.5, w / 4)
    yy, xx = np.mgrid[:h, :w]
    m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.uint8)
    ys, xs = np.nonzero(m)
    return m, [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]


KINDS = ("polygon", "rle", "box", "crowd", "degenerate")


def coco_annotations(rng, h: int, w: int, n_images: int, kinds=KINDS):
    """A COCO dict of ``n_images`` images, each with one annotation of every
    kind in ``kinds`` (categories drawn from 7 and 9), and one more image
    with none."""
    images, anns = [], []
    for i in range(n_images + 1):
        images.append({"id": 10 + i, "file_name": f"im{i}.png", "height": h, "width": w})
        if i == n_images:
            break  # the image without annotations
        for kind in kinds:
            cat = int(rng.choice([7, 9]))
            m, box = _blob(rng, h, w)
            ann = {"id": len(anns) + 1, "image_id": 10 + i, "category_id": cat, "iscrowd": 0,
                   "area": int(m.sum()), "bbox": box}
            if kind == "polygon":
                x, y, bw, bh = box
                ann["segmentation"] = [[x, y, x + bw - 1, y + rng.uniform(0, bh - 1), x + bw - 1, y + bh - 1,
                                        x + rng.uniform(0, bw - 1), y + bh - 1]]
            elif kind == "rle":
                ann["segmentation"] = {"size": [h, w], "counts": [int(c) for c in rle_encode_plain(m)]}
            elif kind == "box":
                ann["bbox"] = [float(rng.uniform(0, w / 2)), float(rng.uniform(0, h / 2)),
                               float(rng.uniform(2, w / 2)), float(rng.uniform(2, h / 2))]
            elif kind == "crowd":
                ann["iscrowd"] = 1
                ann["segmentation"] = {"size": [h, w], "counts": [int(c) for c in rle_encode_plain(m)]}
            elif kind == "degenerate":
                ann["bbox"] = [box[0], box[1], 0, box[3]] if rng.random() < 0.5 else [box[0], box[1], box[2], -1]
            anns.append(ann)
    return {"images": images, "annotations": anns, "categories": CATEGORIES}


def write_coco(root: str, seed: int = 0, h: int = 40, w: int = 56, n_images: int = 3, kinds=KINDS,
               img_subdir: str = "images"):
    """A COCO-format split under ``root``: ``<img_subdir>/im<i>.png`` (random
    RGB) and ``annotations.json``, by default the catalog's ``coco_*``
    layout. Returns (annotation file, image directory, the dict)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    data = coco_annotations(rng, h, w, n_images, kinds)
    img_dir = os.path.join(root, img_subdir)
    os.makedirs(img_dir, exist_ok=True)
    for info in data["images"]:
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(os.path.join(img_dir, info["file_name"]))
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(data, f)
    return ann_file, img_dir, data


def write_voc(root: str, seed: int = 0, n_images: int = 3, h: int = 60, w: int = 80, split: str = "trainval"):
    """A Pascal VOC split under ``root`` (JPEGImages/, Annotations/,
    ImageSets/Main/<split>.txt): up to 4 objects an image of ``VOC_NAMES``,
    every third difficult. Returns the image ids."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ids = []
    for i in range(n_images):
        objs = []
        for j in range(1 + int(rng.integers(0, 4))):
            x1, y1 = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
            x2, y2 = x1 + int(rng.integers(3, w // 2)), y1 + int(rng.integers(3, h // 2))
            objs.append(OBJ_XML.format(name=VOC_NAMES[int(rng.integers(0, len(VOC_NAMES)))],
                                       difficult=int(j % 3 == 2), x1=x1, y1=y1, x2=x2, y2=y2))
        img_id = f"im{i:03d}"
        ids.append(img_id)
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"), "w") as f:
            f.write(VOC_XML.format(w=w, h=h, objects="\n".join(objs)))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "JPEGImages", f"{img_id}.jpg"))
    with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"), "w") as f:
        f.write("".join(f"{i}\n" for i in ids))
    return ids


def assert_same(got, want, what=""):
    """Two values (dicts, lists, arrays, numbers) equal, arrays in dtype,
    shape and every element."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (what, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape, want.dtype,
                                                                    want.shape)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want or (got != got and want != want), (what, got, want)
