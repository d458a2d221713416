"""Image transforms on the host, numpy (the port's copy of
``mmt_psm_tpu/data/transforms.py``, after the
reference's maskrcnn_benchmark/data/transforms/transforms.py:10-205).

A sample is {"image": u8 [H, W, 3] RGB, "boxes": [M, 4], "labels",
"masks": [M, H, W] u8}. ``resize_sample`` resizes as the reference's
Resize does (square images straight to MIN_SIZE, else the shorter side
to MIN_SIZE capped by MAX_SIZE), the image bilinear through PIL, which is
imported only where an image is resized, and the masks nearest;
``normalize_bgr255`` flips RGB to BGR and subtracts the pixel mean.

The training pipelines: ``source_transform`` (resize, a flip with
probability 1/2, ``color_jitter``: brightness and contrast 0.15, hue 0.05
through an HSV round trip, then ``random_erasing``: 0-10 pixel-noise
patches of 0.1-0.4% of the image) and ``unlabeled_transform`` (one shared
resize and flip, then K independent jitter-and-erase views); at test time
``tta_transform`` gives K jitter-and-erase views of one resize. Each draws
from the caller's ``np.random.Generator`` in the JAX package's order, so
the same seed gives the same arrays.
"""

from __future__ import annotations

import numpy as np

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


# ------------------------------------------------------------ colour ops
# torchvision.transforms.functional's formulas (transforms.py:146-205 of the
# reference compose them through its build.py:36-50)
def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img.astype(np.float32) * factor, 0, 255).astype(img.dtype)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # a blend with the mean of the grayscale image
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).mean()
    out = img.astype(np.float32) * factor + gray * (1 - factor)
    return np.clip(out, 0, 255).astype(img.dtype)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    out = 255.0 * gain * (img.astype(np.float32) / 255.0) ** gamma
    return np.clip(out, 0, 255).astype(img.dtype)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    out = img.astype(np.float32) * factor + gray[..., None] * (1 - factor)
    return np.clip(out, 0, 255).astype(img.dtype)


def adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """Shift the hue by ``hue_factor`` (in [-0.5, 0.5]) through HSV."""
    hsv = _rgb_to_hsv(img.astype(np.float32) / 255.0)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv) * 255.0
    return np.clip(out, 0, 255).astype(img.dtype)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-10), 0.0)
    rc = np.where(d > 0, (maxc - r) / np.maximum(d, 1e-10), 0.0)
    gc = np.where(d > 0, (maxc - g) / np.maximum(d, 1e-10), 0.0)
    bc = np.where(d > 0, (maxc - b) / np.maximum(d, 1e-10), 0.0)
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    return np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
         np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1)],
    )


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


def hflip_sample(sample: dict) -> dict:
    """The image, boxes (x1 = w - x2 - 1) and masks mirrored left to right."""
    img = sample["image"]
    w = img.shape[1]
    out = dict(sample)
    out["image"] = img[:, ::-1].copy()
    if "boxes" in sample:
        b = sample["boxes"].copy()
        x1 = w - sample["boxes"][:, 2] - 1
        x2 = w - sample["boxes"][:, 0] - 1
        b[:, 0], b[:, 2] = x1, x2
        out["boxes"] = b
    if "masks" in sample and sample["masks"] is not None and len(sample["masks"]):
        out["masks"] = sample["masks"][:, :, ::-1].copy()
    return out


def random_erasing(img: np.ndarray, rng: np.random.Generator, prob: float) -> np.ndarray:
    """0-10 tries of the pixel-noise eraser (transforms.py:146-205), each
    taken with probability ``prob``: a patch of 0.1-0.4% of the image, aspect
    0.2-5, filled with uniform noise, placed in up to 100 draws."""
    img = img.copy()
    h, w, c = img.shape
    num = rng.integers(0, 11)
    for _ in range(num):
        if rng.random() > prob:
            continue
        for _ in range(100):
            s = rng.uniform(0.001, 0.004) * h * w
            r = rng.uniform(0.2, 1 / 0.2)
            ew = int(np.sqrt(s / r))
            eh = int(np.sqrt(s * r))
            left = rng.integers(0, w)
            top = rng.integers(0, h)
            if left + ew <= w and top + eh <= h:
                img[top : top + eh, left : left + ew] = rng.uniform(0, 255, (eh, ew, c)).astype(img.dtype)
                break
    return img


def color_jitter(img: np.ndarray, rng: np.random.Generator, brightness=0.15, contrast=0.15, hue=0.05) -> np.ndarray:
    """The source and unlabeled colour stack (transforms/build.py:36-50)."""
    img = adjust_brightness(img, rng.uniform(1 - brightness, 1 + brightness))
    img = adjust_contrast(img, rng.uniform(1 - contrast, 1 + contrast))
    return adjust_hue(img, rng.uniform(-hue, hue))


def normalize_bgr255(img: np.ndarray, std: np.ndarray | None = None) -> np.ndarray:
    """RGB u8 -> BGR float32 minus the pixel mean, over ``std`` if given
    (transforms.py:95-99; the reference's PIXEL_STD is 1)."""
    out = img[..., ::-1].astype(np.float32) - PIXEL_MEAN_BGR
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return out


def source_transform(sample: dict, rng: np.random.Generator, min_size=800, max_size=1333, erase_prob=0.7) -> dict:
    """The labeled training pipeline (transforms/build.py:36-50)."""
    sample = resize_sample(sample, min_size, max_size)
    if rng.random() < 0.5:
        sample = hflip_sample(sample)
    img = color_jitter(sample["image"], rng)
    img = random_erasing(img, rng, erase_prob)
    out = dict(sample)
    out["image"] = normalize_bgr255(img)
    return out


def unlabeled_transform(sample: dict, rng: np.random.Generator, k: int, min_size=800, max_size=1333,
                        erase_prob=0.9) -> list:
    """The unlabeled pipeline: one shared resize and flip, then ``k``
    independent jitter-and-erase views (transforms/build.py:21-35,
    Pap.py:818-830). Returns the ``k`` normalized images."""
    sample = resize_sample(sample, min_size, max_size)
    if rng.random() < 0.5:
        sample = hflip_sample(sample)
    outs = []
    for _ in range(k):
        img = color_jitter(sample["image"], rng)
        img = random_erasing(img, rng, erase_prob)
        outs.append(normalize_bgr255(img))
    return outs


def test_transform(sample: dict, min_size=800, max_size=1333) -> dict:
    sample = resize_sample(sample, min_size, max_size)
    out = dict(sample)
    out["image"] = normalize_bgr255(sample["image"])
    return out


def tta_transform(sample: dict, rng: np.random.Generator, k: int, min_size=800, max_size=1333) -> dict:
    """Test-time augmentation (TEST.TTA, transforms/build.py:65-79): one
    resize, no flip, then ``k`` jitter-and-erase views under "views"; the
    resized targets stay for scoring."""
    sample = resize_sample(sample, min_size, max_size)
    views = []
    for _ in range(k):
        img = color_jitter(sample["image"], rng)
        img = random_erasing(img, rng, 0.9)
        views.append(normalize_bgr255(img))
    out = dict(sample)
    out["views"] = views
    return out
