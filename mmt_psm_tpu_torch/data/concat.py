"""Datasets made of others: a concatenation, and a plain list of image
files (the port's copy of ``mmt_psm_tpu/data/concat.py``, after the
reference's concat_dataset.py:1-23 and list_dataset.py:1-36; build_dataset
concatenates the datasets of several names, data/build.py:60-66). A dataset
is anything with ``__len__`` and a ``__getitem__`` that gives the sample
dict {image, boxes, labels, masks}.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np


class ConcatDataset:
    """Several datasets one after the other, with ``get_idxs`` (dataset,
    sample) and ``get_img_info`` passed through (concat_dataset.py)."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = list(np.cumsum([len(d) for d in self.datasets]))

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def get_idxs(self, idx: int):
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else idx - self.cumulative_sizes[dataset_idx - 1]
        return dataset_idx, sample_idx

    def __getitem__(self, idx: int):
        dataset_idx, sample_idx = self.get_idxs(idx)
        return self.datasets[dataset_idx][sample_idx]

    def get_img_info(self, idx: int):
        dataset_idx, sample_idx = self.get_idxs(idx)
        return self.datasets[dataset_idx].get_img_info(sample_idx)


class ListDataset:
    """Images from a list of paths, each with its annotations or None
    (list_dataset.py): ``annotations[i]`` holds boxes [M, 4] xyxy, labels
    [M] and masks [M, H, W]."""

    def __init__(self, image_paths: Sequence[str], annotations: Sequence[dict] | None = None):
        self.image_paths = list(image_paths)
        self.annotations = list(annotations) if annotations is not None else [None] * len(self.image_paths)
        if len(self.image_paths) != len(self.annotations):
            raise ValueError(f"{len(self.image_paths)} images but {len(self.annotations)} annotations")

    def __len__(self):
        return len(self.image_paths)

    def get_img_info(self, idx: int):
        from PIL import Image

        with Image.open(self.image_paths[idx]) as im:
            return {"height": im.height, "width": im.width, "file_name": self.image_paths[idx]}

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        image = np.asarray(Image.open(self.image_paths[idx]).convert("RGB"))
        ann = self.annotations[idx]
        h, w = image.shape[:2]
        if ann is None:
            return {"image": image, "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int32),
                    "masks": np.zeros((0, h, w), np.uint8)}
        return {
            "image": image,
            "boxes": np.asarray(ann["boxes"], np.float32).reshape(-1, 4),
            "labels": np.asarray(ann["labels"], np.int32),
            "masks": np.asarray(ann["masks"], np.uint8).reshape(-1, h, w),
        }
