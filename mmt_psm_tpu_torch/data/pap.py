"""Pap cervical-cell dataset: sliding-window crops and gt filtering (the
port's copy of ``mmt_psm_tpu/data/pap.py``, after the reference's
maskrcnn_benchmark/data/datasets/Pap.py:105-866), over full-frame
instance bitmasks:

* whole-slide images are tiled by a sliding window (winSize 1000,
  overlap 0.75 train / 0 eval, Pap.py:20-31, 47-53);
* per window, instances are cropped to it and dropped when the in-window
  area falls below a fraction of the full instance area (filter_gt /
  _modify_out_of_roi_masks, Pap.py:312-359);
* for training, windows whose total gt box area is below 0.001 x
  winSize^2 are removed (_remove_unsuitable_patches, Pap.py:361-383).

A slide is anything indexable as an RGB array: a numpy array, a path to
an image file (PIL, imported only there) or an OpenSlide handle.
``synthetic_slide_dataset`` builds slides from the synthetic cells of
``data/synthetic.py``. ``PapUnlabeledDataset`` holds the loose unlabeled
patches of the mean teacher.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


def generate_windows(h: int, w: int, win: int, overlap: float) -> List[tuple]:
    """Sliding-window origins [(x, y), ...] covering an h x w frame
    (the slidingwindow-package semantics used at Pap.py:47-53)."""
    if h <= win and w <= win:
        return [(0, 0)]
    step = max(1, int(win * (1.0 - overlap)))

    def starts(dim):
        if dim <= win:
            return [0]
        s = list(range(0, dim - win + 1, step))
        if s[-1] != dim - win:
            s.append(dim - win)
        return s

    return [(x, y) for y in starts(h) for x in starts(w)]


@dataclass
class SlideAnnotations:
    """Full-frame instances for one slide."""

    boxes: np.ndarray  # f32 [M, 4] xyxy
    labels: np.ndarray  # i32 [M]
    masks: List[np.ndarray]  # M full-frame (or box-local+boxes) bool arrays


def _read_region(slide, x, y, win):
    """RGB u8 crop [win, win, 3] from ndarray / PIL path / OpenSlide."""
    if isinstance(slide, np.ndarray):
        h, w = slide.shape[:2]
        out = np.zeros((win, win, 3), np.uint8)
        crop = slide[y : min(y + win, h), x : min(x + win, w)]
        out[: crop.shape[0], : crop.shape[1]] = crop[..., :3]
        return out
    if isinstance(slide, str):
        from PIL import Image

        img = np.asarray(Image.open(slide).convert("RGB"))
        return _read_region(img, x, y, win)
    # OpenSlide-like object
    region = slide.read_region((x, y), 0, (win, win))
    return np.asarray(region.convert("RGB"))


def _instance_geometry(ann: SlideAnnotations):
    """Per-instance (y0, y1, x0, x1, area) of each full-frame mask's true
    support, computed ONCE per slide and cached on the annotation object.

    The support box lets every window-level scan in crop_window_gt run
    on the instance-sized crop instead of the full slide mask, which is
    exact because the mask is zero outside it."""
    # Cache key: the list identity AND each element's identity.
    # SlideAnnotations.masks is treated as immutable after construction;
    # the per-element id tuple guards against element reassignment in the
    # same list. In-place mutation of a mask *array* is still undetectable
    # (and unsupported) — don't do it.
    key = (id(ann.masks), tuple(id(m) for m in ann.masks))
    cache = getattr(ann, "_geom_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    geom = []
    for m in ann.masks:
        rows = np.flatnonzero(m.any(axis=1))
        if rows.size == 0:
            geom.append((0, -1, 0, -1, 0))
            continue
        cols = np.flatnonzero(m.any(axis=0))
        y0, y1, x0, x1 = int(rows[0]), int(rows[-1]), int(cols[0]), int(cols[-1])
        area = int(np.count_nonzero(m[y0 : y1 + 1, x0 : x1 + 1]))
        geom.append((y0, y1, x0, x1, area))
    ann._geom_cache = (key, geom)
    return geom


def crop_window_gt(ann: SlideAnnotations, x: int, y: int, win: int, area_ratio_cutoff: float = 0.005):
    """Crop instances to a window, dropping tiny remnants
    (Pap.py:312-359). Returns (boxes, labels, masks) window-local.

    All per-window mask scans run on the instance's true-support crop
    (see _instance_geometry), which gives the same outputs as slicing the
    full frame."""
    geom = _instance_geometry(ann)
    boxes, labels, masks = [], [], []
    for i in range(len(ann.labels)):
        bx = ann.boxes[i]
        if bx[2] < x or bx[0] >= x + win or bx[3] < y or bx[1] >= y + win:
            continue
        m = ann.masks[i]
        y0, y1, x0, x1, full_area = geom[i]
        if full_area == 0:
            continue
        # intersect the instance support with the window
        iy0, iy1 = max(y0, y), min(y1, y + win - 1)
        ix0, ix1 = max(x0, x), min(x1, x + win - 1)
        if iy0 > iy1 or ix0 > ix1:
            continue  # support misses the window -> in-window area 0
        region = m[iy0 : iy1 + 1, ix0 : ix1 + 1]
        area = int(np.count_nonzero(region))
        if area / full_area < area_ratio_cutoff or area < 4:
            continue
        # tight in-window bbox from the region's own support
        rrows = np.flatnonzero(region.any(axis=1))
        rcols = np.flatnonzero(region.any(axis=0))
        ry0, ry1 = iy0 - y + int(rrows[0]), iy0 - y + int(rrows[-1])
        rx0, rx1 = ix0 - x + int(rcols[0]), ix0 - x + int(rcols[-1])
        local = np.zeros((win, win), bool)
        local[iy0 - y : iy1 + 1 - y, ix0 - x : ix1 + 1 - x] = region
        boxes.append([rx0, ry0, rx1, ry1])
        labels.append(int(ann.labels[i]))
        masks.append(local)
    if not boxes:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), []
    return np.asarray(boxes, np.float32), np.asarray(labels, np.int32), masks


class PapDataset:
    """Labeled sliding-window dataset (train 'source' or eval mode).

    Parity knobs beyond the window/filter pipeline:

    * ``train_ratio`` — keep only the first fraction of train windows
      (PapNucleiSourceDataset ratio subsetting, Pap.py:494-496);
    * ``resample_empty`` — when a window's filtered GT comes out empty
      at train time, draw a replacement index (Pap.py:225-255); with
      ``require_both_classes`` the redraw also fires unless both
      foreground classes are present (Pap.py:570-573);
    * ``cache_dir`` — pre-crop train windows to PNGs once and read them
      back instead of re-cropping the slide (store_tmp_train_patches,
      Pap.py:193-223);
    * ``area_ratio_cutoff`` — the __getitem__ GT filter threshold:
      the reference uses 0.05 for train/val and 0.005 for test
      (Pap.py:293, 622).
    """

    def __init__(
        self,
        slides: Sequence,
        annotations: Sequence[SlideAnnotations],
        win_size: int = 1000,
        overlap: float = 0.75,
        is_train: bool = True,
        min_patch_gt_area_ratio: float = 0.001,
        train_ratio: float = 1.0,
        resample_empty: bool | None = None,
        require_both_classes: bool = False,
        cache_dir: str | None = None,
        area_ratio_cutoff: float | None = None,
        seed: int = 0,
    ):
        assert len(slides) == len(annotations)
        self.slides = list(slides)
        self.annotations = list(annotations)
        self.win_size = win_size
        self.is_train = is_train
        self.resample_empty = is_train if resample_empty is None else resample_empty
        self.require_both_classes = require_both_classes
        self.area_ratio_cutoff = area_ratio_cutoff if area_ratio_cutoff is not None else (0.05 if is_train else 0.005)
        self._rng = np.random.default_rng(seed)
        self.index = []  # (slide_idx, x, y)
        for si, (slide, ann) in enumerate(zip(self.slides, self.annotations)):
            h, w = self._slide_hw(slide)
            for (x, y) in generate_windows(h, w, win_size, overlap if is_train else 0.0):
                if is_train:
                    # _remove_unsuitable_patches (Pap.py:361-383)
                    b = ann.boxes
                    inter_w = np.minimum(b[:, 2], x + win_size) - np.maximum(b[:, 0], x)
                    inter_h = np.minimum(b[:, 3], y + win_size) - np.maximum(b[:, 1], y)
                    area = np.clip(inter_w, 0, None) * np.clip(inter_h, 0, None)
                    if area.sum() <= min_patch_gt_area_ratio * win_size**2:
                        continue
                self.index.append((si, x, y))
        if is_train and train_ratio < 1.0:
            # Pap.py:494-496: self.ids = self.ids[: int(total * ratio)]
            self.index = self.index[: int(len(self.index) * train_ratio)]
        self.cache_dir = None
        self._cache_paths = {}
        if cache_dir is not None and is_train:
            self._store_tmp_train_patches(cache_dir)

    @staticmethod
    def _slide_hw(slide):
        if isinstance(slide, np.ndarray):
            return slide.shape[:2]
        if isinstance(slide, str):
            from PIL import Image

            with Image.open(slide) as im:
                return im.height, im.width
        w, h = slide.dimensions
        return h, w

    def _store_tmp_train_patches(self, cache_dir: str):
        """Crop every train window to a PNG once; reuse existing files
        (Pap.py:193-223)."""
        import os

        from PIL import Image

        os.makedirs(cache_dir, exist_ok=True)
        self.cache_dir = cache_dir
        for i, (si, x, y) in enumerate(self.index):
            path = os.path.join(cache_dir, f"slide{si}_{x}_{y}.png")
            if not os.path.exists(path):
                Image.fromarray(_read_region(self.slides[si], x, y, self.win_size)).save(path)
            self._cache_paths[i] = path

    def __len__(self):
        return len(self.index)

    def _read_window(self, i: int) -> np.ndarray:
        if i in self._cache_paths:
            from PIL import Image

            return np.asarray(Image.open(self._cache_paths[i]).convert("RGB"))
        si, x, y = self.index[i]
        return _read_region(self.slides[si], x, y, self.win_size)

    def __getitem__(self, i) -> dict:
        while True:
            si, x, y = self.index[i]
            boxes, labels, masks = crop_window_gt(
                self.annotations[si], x, y, self.win_size, self.area_ratio_cutoff
            )
            bad = len(masks) == 0 or (
                self.require_both_classes and not {1, 2} <= set(labels.tolist())
            )
            if not (bad and self.resample_empty):
                break
            # empty-window redraw (Pap.py:225-255, 570-573)
            i = int(self._rng.integers(len(self.index)))
        img = self._read_window(i)
        return {
            "image": img,
            "boxes": boxes,
            "labels": labels,
            "masks": np.stack(masks).astype(np.uint8) if masks else np.zeros((0, self.win_size, self.win_size), np.uint8),
        }


class PapUnlabeledDataset:
    """Loose unlabeled patches (reference PapNucleiUnlabelDataset,
    Pap.py:762-866): each item is one RGB patch, an array or an image file;
    the loader makes its K + S views."""

    def __init__(self, patches: Sequence):
        self.patches = list(patches)

    def __len__(self):
        return len(self.patches)

    def __getitem__(self, i) -> np.ndarray:
        p = self.patches[i]
        if isinstance(p, np.ndarray):
            return p[..., :3]
        from PIL import Image

        return np.asarray(Image.open(p).convert("RGB"))


def synthetic_slide_dataset(seed: int = 0, num_slides: int = 2, slide_size: int = 512, win_size: int = 256, overlap: float = 0.5, is_train: bool = True, train_ratio: float = 1.0, num_cells: tuple = (8, 16), radius_range: tuple = (0.08, 0.18)):
    """Self-contained PapDataset over synthetic overlapping-cell slides.

    ``num_cells``/``radius_range`` forward to the window generator —
    larger slides should shrink ``radius_range`` (it is a fraction of
    the SLIDE) to keep per-window cell sizes realistic."""
    from .synthetic import generate_sample

    rng = np.random.default_rng(seed)
    slides, anns = [], []
    for _ in range(num_slides):
        s = generate_sample(rng, image_size=slide_size, max_instances=128, num_cells=num_cells, radius_range=radius_range)
        n = int(s.valid.sum())
        slides.append(s.image.astype(np.uint8))
        anns.append(
            SlideAnnotations(
                boxes=s.boxes[:n],
                labels=s.labels[:n],
                masks=[s.masks[i].astype(bool) for i in range(n)],
            )
        )
    return PapDataset(
        slides, anns, win_size=win_size, overlap=overlap, is_train=is_train, train_ratio=train_ratio
    )
