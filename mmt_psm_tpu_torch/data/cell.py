"""COCO-style annotation index (the port's copy of
``mmt_psm_tpu/data/cell.py``, after the reference's CELL class, its local
clone of the pycocotools COCO API, maskrcnn_benchmark/data/datasets/
cell.py:53-347): an in-memory index over a COCO-format dict with
getAnnIds / getCatIds / getImgIds / loadAnns / loadCats / loadImgs. Plain
Python, no pycocotools.
"""

from __future__ import annotations

import json
from collections import defaultdict


def _as_list(x) -> list:
    """None -> [], a list as it is, anything else -> [x] (pycocotools)."""
    if x is None:
        return []
    return x if isinstance(x, list) else [x]


class CELL:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns, self.cats, self.imgs = {}, {}, {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            if not isinstance(self.dataset, dict):
                raise TypeError(f"a COCO annotation file holds a dict, not {type(self.dataset).__name__}")
            self.createIndex()

    def createIndex(self):
        """cell.py:75-104."""
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
            catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        self.anns, self.imgs, self.cats = anns, imgs, cats
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):
        imgIds, catIds, areaRng = _as_list(imgIds), _as_list(catIds), areaRng or []
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if imgIds:
                anns = [a for i in imgIds if i in self.imgToAnns for a in self.imgToAnns[i]]
            else:
                anns = self.dataset.get("annotations", [])
            if catIds:
                anns = [a for a in anns if a["category_id"] in catIds]
            if areaRng:
                anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            return [a["id"] for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        catNms, supNms, catIds = _as_list(catNms), _as_list(supNms), _as_list(catIds)
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=None, catIds=None):
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        if len(imgIds) == len(catIds) == 0:
            return list(set(self.imgs))
        ids = set(imgIds)
        for i, catId in enumerate(catIds):
            if i == 0 and not ids:
                ids = set(self.catToImgs[catId])
            else:
                ids &= set(self.catToImgs[catId])
        return list(ids)

    def loadAnns(self, ids=None):
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids=None):
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids=None):
        return [self.imgs[i] for i in _as_list(ids)]
