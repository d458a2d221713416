"""Cityscapes gtFine -> COCO instance-segmentation JSON (the port's copy of
``tools/cityscapes/convert_cityscapes_to_coco.py``, after the reference's
tools/cityscapes/convert_cityscapes_to_coco.py:93-216 and
instances2dict_with_polygons.py).

    python -m mmt_psm_tpu_torch.tools.convert_cityscapes_to_coco --datadir CITYSCAPES --outdir OUT

Walks the gtFine split directories, takes each instance's outer contours
from its ``*_instanceIds.png`` (pixel value class_id * 1000 + index), keeps
the 8 instance classes and writes ``instancesonly_filtered_gtFine_<split>.json``
with polygon segmentations, pixel-count areas and xywh boxes. Needs
OpenCV (``cv2``) for the contours.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

CATEGORY_INSTANCESONLY = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")

# the Cityscapes label ids of the instance classes
CITYSCAPES_ID_TO_NAME = {24: "person", 25: "rider", 26: "car", 27: "truck", 28: "bus", 31: "train",
                         32: "motorcycle", 33: "bicycle"}


def convert_cityscapes_instance_only(data_dir: str, out_dir: str, splits=("val", "train", "test")):
    from PIL import Image

    from ..utils.segms import instances_to_dict_with_polygons, polys_to_boxes

    os.makedirs(out_dir, exist_ok=True)
    img_id = ann_id = 0
    cat_id = 1
    category_dict = {}
    for split in splits:
        ann_dir = os.path.join(data_dir, "gtFine_trainvaltest", "gtFine", split)
        if not os.path.isdir(ann_dir):
            ann_dir = os.path.join(data_dir, "gtFine", split)
        if not os.path.isdir(ann_dir):
            print(f"skipping {split}: no annotation dir")
            continue
        images, annotations = [], []
        for root, _, files in os.walk(ann_dir):
            for filename in sorted(files):
                if not filename.endswith("gtFine_polygons.json"):
                    continue
                with open(os.path.join(root, filename)) as f:
                    json_ann = json.load(f)
                stem = filename[: -len("gtFine_polygons.json")]
                image = {"id": img_id, "width": json_ann["imgWidth"], "height": json_ann["imgHeight"],
                         "file_name": stem + "leftImg8bit.png", "seg_file_name": stem + "gtFine_instanceIds.png"}
                img_id += 1
                images.append(image)

                inst_img = np.asarray(Image.open(os.path.join(root, image["seg_file_name"])))
                objects = instances_to_dict_with_polygons(inst_img, CITYSCAPES_ID_TO_NAME)
                for object_cls, objs in objects.items():
                    if object_cls not in CATEGORY_INSTANCESONLY:
                        continue
                    for obj in objs:
                        if not obj["contours"]:
                            print("Warning: empty contours.")
                            continue
                        if min(len(p) for p in obj["contours"]) <= 4:
                            print("Warning: invalid contours.")
                            continue
                        if object_cls not in category_dict:
                            category_dict[object_cls] = cat_id
                            cat_id += 1
                        x1, y1, x2, y2 = polys_to_boxes([obj["contours"]])[0]
                        annotations.append({
                            "id": ann_id, "image_id": image["id"], "segmentation": obj["contours"],
                            "category_id": category_dict[object_cls], "iscrowd": 0, "area": obj["pixelCount"],
                            "bbox": [x1, y1, x2 - x1, y2 - y1],
                        })
                        ann_id += 1
        out = {"images": images, "categories": [{"id": v, "name": k} for k, v in category_dict.items()],
               "annotations": annotations}
        path = os.path.join(out_dir, f"instancesonly_filtered_gtFine_{split}.json")
        with open(path, "w") as f:
            json.dump(out, f)
        print(f"{split}: {len(images)} images, {len(annotations)} annotations -> {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert cityscapes to COCO format")
    parser.add_argument("--datadir", required=True)
    parser.add_argument("--outdir", required=True)
    args = parser.parse_args(argv)
    convert_cityscapes_instance_only(args.datadir, args.outdir)


if __name__ == "__main__":
    main()
