"""Pascal VOC dataset, XML annotations (the port's copy of
``mmt_psm_tpu/data/voc.py``, after the reference's PascalVOCDataset,
maskrcnn_benchmark/data/datasets/voc.py:17-134): the standard layout
(JPEGImages/, Annotations/*.xml, ImageSets/Main/<split>.txt), pixel
indexes made 0-based (TO_REMOVE = 1, voc.py:96-108), ``difficult`` objects
dropped unless ``use_difficult``. Each box filled is its mask (VOC has no
instance masks), so the sample dict is the shared one;
``get_groundtruth`` gives the difficult flags to the VOC evaluator.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

VOC_CLASSES = (
    "__background__ ",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair", "cow", "diningtable", "dog",
    "horse", "motorbike", "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVOCDataset:
    CLASSES = VOC_CLASSES

    def __init__(self, data_dir: str, split: str, use_difficult: bool = False):
        self.root = data_dir
        self.image_set = split
        self.keep_difficult = use_difficult
        self._annopath = os.path.join(self.root, "Annotations", "%s.xml")
        self._imgpath = os.path.join(self.root, "JPEGImages", "%s.jpg")
        self._imgsetpath = os.path.join(self.root, "ImageSets", "Main", "%s.txt")
        with open(self._imgsetpath % split) as f:
            self.ids = [x.strip("\n") for x in f.readlines()]
        self.id_to_img_map = dict(enumerate(self.ids))
        self.class_to_ind = dict(zip(self.CLASSES, range(len(self.CLASSES))))

    def __len__(self):
        return len(self.ids)

    def _preprocess_annotation(self, target):
        boxes, gt_classes, difficult_boxes = [], [], []
        to_remove = 1
        for obj in target.iter("object"):
            difficult = int(obj.find("difficult").text) == 1
            if not self.keep_difficult and difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            boxes.append([int(bb.find(t).text) - to_remove for t in ("xmin", "ymin", "xmax", "ymax")])
            gt_classes.append(self.class_to_ind[name])
            difficult_boxes.append(difficult)
        size = target.find("size")
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(gt_classes, np.int32),
            "difficult": np.asarray(difficult_boxes, bool),
            "im_info": (int(size.find("height").text), int(size.find("width").text)),
        }

    def get_groundtruth(self, index) -> dict:
        return self._preprocess_annotation(ET.parse(self._annopath % self.ids[index]).getroot())

    def get_img_info(self, index):
        size = ET.parse(self._annopath % self.ids[index]).getroot().find("size")
        return {"height": int(size.find("height").text), "width": int(size.find("width").text)}

    def map_class_id_to_class_name(self, class_id: int) -> str:
        return self.CLASSES[class_id]

    def __getitem__(self, index) -> dict:
        from PIL import Image

        image = np.asarray(Image.open(self._imgpath % self.ids[index]).convert("RGB"))
        gt = self.get_groundtruth(index)
        h, w = image.shape[:2]
        masks = np.zeros((len(gt["boxes"]), h, w), np.uint8)
        for i, (x1, y1, x2, y2) in enumerate(gt["boxes"].astype(int)):
            masks[i, max(y1, 0) : y2 + 1, max(x1, 0) : x2 + 1] = 1
        return {"image": image, "boxes": gt["boxes"], "labels": gt["labels"], "masks": masks}
