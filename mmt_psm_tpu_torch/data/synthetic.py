"""Synthetic cervical-cell-like data (the port's own copy of
``mmt_psm_tpu/data/synthetic.py:39-131``; no dataset is in the repository).

Overlapping ellipse "cells": class 1 = cytoplasm (large, translucent),
class 2 = nucleus (small, dark, inside its cytoplasm), the 2-foreground-
class structure of the Pap dataset, with boxes, labels and full-image
masks, made from a seed in numpy. Outputs are fixed-shape padded arrays;
``batch_to_torch`` moves a batch to a device as the train step takes it.
``generate_unlabeled_batch`` makes the mean teacher's K-aug unlabeled batch
the JAX package's bench and tests use (``bench_train.py:73-84``): each view
is the normalized image plus its own N(0, 4) noise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SyntheticSample(NamedTuple):
    image: np.ndarray  # f32 [H, W, 3] raw 0-255 BGR
    boxes: np.ndarray  # f32 [M, 4]
    labels: np.ndarray  # i32 [M]
    masks: np.ndarray  # u8 [M, Hm, Wm]
    valid: np.ndarray  # bool [M]
    image_size: np.ndarray  # i32 [2] (h, w)


def _ellipse_mask(h, w, cy, cx, ry, rx, angle):
    yy, xx = np.mgrid[0:h, 0:w]
    ca, sa = np.cos(angle), np.sin(angle)
    dy, dx = yy - cy, xx - cx
    u = (dx * ca + dy * sa) / rx
    v = (-dx * sa + dy * ca) / ry
    return (u * u + v * v) <= 1.0


def generate_sample(
    rng: np.random.Generator,
    image_size: int = 256,
    mask_size: int | None = None,
    max_instances: int = 64,
    num_cells: tuple = (3, 8),
    radius_range: tuple = (0.08, 0.18),
) -> SyntheticSample:
    """``radius_range`` scales cell radii as a fraction of the canvas;
    the default keeps the historical distribution (cells 16-36% of the
    image). Larger values produce the jumbo instances that exercise FPN
    level-mapper levels >= 4 (reference poolers.py:11-42: level 4 needs
    sqrt(area) >= 448 px)."""
    mask_size = mask_size or image_size
    h = w = image_size
    img = rng.normal(200, 10, (h, w, 3)).astype(np.float32)  # bright background

    boxes, labels, masks = [], [], []
    n_cells = rng.integers(num_cells[0], num_cells[1] + 1)
    for _ in range(n_cells):
        if len(boxes) + 2 > max_instances:
            break
        cy, cx = rng.uniform(0.15 * h, 0.85 * h), rng.uniform(0.15 * w, 0.85 * w)
        ry = rng.uniform(*radius_range) * h
        rx = rng.uniform(*radius_range) * w
        ang = rng.uniform(0, np.pi)
        cyto = _ellipse_mask(h, w, cy, cx, ry, rx, ang)
        if cyto.sum() < 16:
            continue
        color = rng.uniform(100, 180, 3)
        img[cyto] = 0.6 * img[cyto] + 0.4 * color

        nry, nrx = ry * rng.uniform(0.25, 0.4), rx * rng.uniform(0.25, 0.4)
        ncy = cy + rng.uniform(-0.3, 0.3) * ry
        ncx = cx + rng.uniform(-0.3, 0.3) * rx
        nuc = _ellipse_mask(h, w, ncy, ncx, nry, nrx, ang)
        nuc &= cyto
        img[nuc] = 0.3 * img[nuc] + 0.7 * rng.uniform(30, 80, 3)

        for m, lab in ((cyto, 1), (nuc, 2)):
            ys, xs = np.nonzero(m)
            if len(ys) < 9:
                continue
            boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
            labels.append(lab)
            masks.append(m)

    m = max_instances
    out_boxes = np.zeros((m, 4), np.float32)
    out_labels = np.zeros((m,), np.int32)
    out_masks = np.zeros((m, mask_size, mask_size), np.uint8)
    out_valid = np.zeros((m,), bool)
    n = min(len(boxes), m)
    if n:
        out_boxes[:n] = np.asarray(boxes, np.float32)[:n]
        out_labels[:n] = np.asarray(labels, np.int32)[:n]
        for i in range(n):
            if mask_size == image_size:
                out_masks[i] = masks[i]
            else:
                # nearest-neighbor downsample
                step = image_size // mask_size
                out_masks[i] = masks[i][::step, ::step][:mask_size, :mask_size]
        out_valid[:n] = True
    img = np.clip(img, 0, 255)
    return SyntheticSample(
        image=img,
        boxes=out_boxes,
        labels=out_labels,
        masks=out_masks,
        valid=out_valid,
        image_size=np.array([h, w], np.int32),
    )


def generate_batch(seed: int, batch_size: int, image_size: int = 256, mask_size: int | None = None, max_instances: int = 64):
    """Stacked batch dict of fixed-shape numpy arrays."""
    rng = np.random.default_rng(seed)
    samples = [generate_sample(rng, image_size, mask_size, max_instances) for _ in range(batch_size)]
    return {
        "image": np.stack([s.image for s in samples]),
        "boxes": np.stack([s.boxes for s in samples]),
        "labels": np.stack([s.labels for s in samples]),
        "masks": np.stack([s.masks for s in samples]),
        "gt_valid": np.stack([s.valid for s in samples]),
        "image_size": np.stack([s.image_size for s in samples]),
    }


# Reference normalization: BGR 0-255 minus per-channel mean
# (reference config/defaults.py:48-52).
PIXEL_MEAN = np.array([102.9801, 115.9465, 122.7717], np.float32)


def normalize_image(img_bgr255: np.ndarray) -> np.ndarray:
    return img_bgr255 - PIXEL_MEAN


def batch_to_torch(batch, device) -> dict:
    """A ``generate_batch`` dict -> tensors on ``device``, the image
    normalized: the ``image``, ``image_size``, ``boxes``, ``labels``,
    ``gt_valid`` and ``masks`` (uint8) that ``Trainer.step`` reads."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out["image"] = torch.from_numpy(normalize_image(batch["image"]))
    return {k: v.to(device) for k, v in out.items()}


# the view noise's seed in the unlabeled recipe (bench_train.py:75)
UNLABELED_NOISE_SEED = 3


def generate_unlabeled_batch(seed: int, batch_size: int, image_size: int = 256, aug_k: int = 2, aug_s: int = 1,
                             max_instances: int = 64):
    """An unlabeled batch of ``batch_size`` synthetic images: ``t_images``
    f32 [B, K, H, W, 3] (the teacher's K views) and ``s_images`` f32
    [B, S, H, W, 3] (the student's), each view the normalized image plus
    N(0, 4) noise from a generator seeded with ``UNLABELED_NOISE_SEED``, and
    ``image_size`` [B, 2]."""
    b = generate_batch(seed, batch_size, image_size=image_size, max_instances=max_instances)
    base = normalize_image(b["image"])
    rng = np.random.default_rng(UNLABELED_NOISE_SEED)
    views = lambda n: np.stack([base + rng.normal(0, 4, base.shape) for _ in range(n)], 1).astype(np.float32)  # noqa: E731
    return {"t_images": views(aug_k), "s_images": views(aug_s), "image_size": b["image_size"]}


def unlabeled_to_torch(batch, device) -> dict:
    """A ``generate_unlabeled_batch`` dict -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
