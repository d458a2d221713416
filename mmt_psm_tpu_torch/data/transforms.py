"""Test-time image transforms on the host, numpy (the port's copy of the
test-time part of ``mmt_psm_tpu/data/transforms.py``, after the
reference's maskrcnn_benchmark/data/transforms/transforms.py:10-99).

A sample is {"image": u8 [H, W, 3] RGB, "boxes": [M, 4], "labels",
"masks": [M, H, W] u8}. ``resize_sample`` resizes as the reference's
Resize does (square images straight to MIN_SIZE, else the shorter side
to MIN_SIZE capped by MAX_SIZE), the image bilinear through PIL, which is
imported only where an image is resized, and the masks nearest;
``normalize_bgr255`` flips RGB to BGR and subtracts the pixel mean. The
training augmentations are not here yet (ROADMAP item 27).
"""

from __future__ import annotations

import numpy as np

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


def resize_sample(sample: dict, min_size: int, max_size: int) -> dict:
    """Reference Resize semantics (transforms.py:25-72): square images go
    straight to (min_size, min_size) (:40-43); otherwise min-side scale
    capped by max_size. Masks use nearest; image bilinear (PIL)."""
    img = sample["image"]
    h, w = img.shape[:2]
    if h == w:
        new_h = new_w = min_size
    else:
        size = min_size
        mx = max(h, w)
        mn = min(h, w)
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
        if h < w:
            new_h, new_w = size, int(size * w / h)
        else:
            new_h, new_w = int(size * h / w), size
    if (new_h, new_w) == (h, w):
        return sample
    from PIL import Image

    out = dict(sample)
    out["image"] = np.asarray(Image.fromarray(img).resize((new_w, new_h), Image.BILINEAR))
    sx, sy = new_w / w, new_h / h
    if "boxes" in sample:
        out["boxes"] = sample["boxes"] * np.array([sx, sy, sx, sy], np.float32)
    if "masks" in sample and sample["masks"] is not None and len(sample["masks"]):
        out["masks"] = _resize_masks_nearest(sample["masks"], new_h, new_w)
    return out


def _resize_masks_nearest(ms: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """NEAREST resize of the [N, H, W] mask stack in one numpy gather,
    bit-identical to ``PIL.Image.resize(..., NEAREST)`` of each mask."""
    ix = _pil_nearest_index(ms.shape[2], new_w)
    iy = _pil_nearest_index(ms.shape[1], new_h)
    return np.ascontiguousarray(ms[:, iy[:, None], ix[None, :]])


def _pil_nearest_index(old: int, new: int) -> np.ndarray:
    """PIL's nearest kernel adds the step to a running source coordinate
    and floors the sum; floor((i + 0.5) * scale) differs from it at exact
    ties (e.g. 640 -> 1066), so the sum is reproduced as a cumsum."""
    s = old / new
    acc = np.cumsum(np.concatenate([[0.5 * s], np.full(new - 1, s)]))
    return np.minimum(np.floor(acc).astype(np.int64), old - 1)


def normalize_bgr255(img: np.ndarray, std: np.ndarray | None = None) -> np.ndarray:
    """RGB u8 -> BGR float32 minus the pixel mean, over ``std`` if given
    (transforms.py:95-99; the reference's PIXEL_STD is 1)."""
    out = img[..., ::-1].astype(np.float32) - PIXEL_MEAN_BGR
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return out


def test_transform(sample: dict, min_size=800, max_size=1333) -> dict:
    sample = resize_sample(sample, min_size, max_size)
    out = dict(sample)
    out["image"] = normalize_bgr255(sample["image"])
    return out
