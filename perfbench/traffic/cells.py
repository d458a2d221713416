"""Synthetic Pap windows, made on the device from the seed.

A frozen copy of the generator the program's tests and tools use
(``mmt_psm_tpu_torch/data/synthetic.py::generate_sample``), batched on the
card: a bright noisy background, then in turn each of 3 to 8 overlapping
ellipse cells, a translucent cytoplasm (class 1) with a dark nucleus
(class 2) inside it. Every number of the distribution comes from the
traffic mix's file (``perfbench/traffic/<mix>.json``): the window size, the
canvas it sits on, the cells a window holds, their radii and colours.

Serving windows are raw RGB uint8 canvases (the serving loaders'
``raw_u8`` form), training batches normalized float canvases with their
ground truth; either way the window sits at the top left of the canvas,
zeros outside it.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _ellipses(h, w, cy, cx, ry, rx, ang, device):
    """Masks [n, h, w] of one ellipse per window (params [n])."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    ca, sa = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    dy, dx = yy - cy[:, None, None], xx - cx[:, None, None]
    u = (dx * ca + dy * sa) / rx[:, None, None]
    v = (-dx * sa + dy * ca) / ry[:, None, None]
    return u * u + v * v <= 1.0


def _scene(n: int, mix: dict, gen: torch.Generator, device, keep_masks: bool):
    """BGR float windows [n, h, w, 3] and, with ``keep_masks``, the instance
    masks [n, 2 x most cells, h, w] (cell i's cytoplasm at 2i, its nucleus
    at 2i + 1) and the cell counts [n]."""
    h, w = mix["window"]
    bg_mean, bg_std = mix["background"]
    img = bg_mean + bg_std * torch.randn((n, h, w, 3), generator=gen, device=device)
    lo, hi = mix["cells"]
    n_cells = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    rlo, rhi = mix["radius"]
    clo, chi = mix["cytoplasm_colour"]
    nlo, nhi = mix["nucleus_colour"]
    masks = []
    for i in range(hi):
        cy, cx = _uniform(gen, (n,), 0.15 * h, 0.85 * h, device), _uniform(gen, (n,), 0.15 * w, 0.85 * w, device)
        ry, rx = _uniform(gen, (n,), rlo, rhi, device) * h, _uniform(gen, (n,), rlo, rhi, device) * w
        ang = _uniform(gen, (n,), 0.0, math.pi, device)
        colour = _uniform(gen, (n, 3), clo, chi, device)
        cyto = _ellipses(h, w, cy, cx, ry, rx, ang, device) & (i < n_cells)[:, None, None]
        img = torch.where(cyto[..., None], 0.6 * img + 0.4 * colour[:, None, None, :], img)
        nry, nrx = ry * _uniform(gen, (n,), 0.25, 0.4, device), rx * _uniform(gen, (n,), 0.25, 0.4, device)
        ncy = cy + _uniform(gen, (n,), -0.3, 0.3, device) * ry
        ncx = cx + _uniform(gen, (n,), -0.3, 0.3, device) * rx
        ncolour = _uniform(gen, (n, 3), nlo, nhi, device)
        nuc = _ellipses(h, w, ncy, ncx, nry, nrx, ang, device) & cyto
        img = torch.where(nuc[..., None], 0.3 * img + 0.7 * ncolour[:, None, None, :], img)
        if keep_masks:
            masks += [cyto, nuc]
    return img.clamp(0, 255), (torch.stack(masks, 1) if keep_masks else None), n_cells


@torch.no_grad()
def windows(n: int, mix: dict, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` raw RGB uint8 canvases [n, canvas, canvas, 3] of the mix."""
    img, _, _ = _scene(n, mix, gen, device, False)
    h, w = mix["window"]
    c = mix["canvas"]
    out = torch.zeros((n, c, c, 3), dtype=torch.uint8, device=device)
    out[:, :h, :w] = img.flip(-1).to(torch.uint8)  # BGR -> RGB
    return out


PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)


def _normalized(img, canvas: int):
    """BGR 0-255 windows -> minus the pixel mean, on the canvas, 0 outside."""
    n, h, w, _ = img.shape
    out = torch.zeros((n, canvas, canvas, 3), dtype=torch.float32, device=img.device)
    out[:, :h, :w] = img - torch.tensor(PIXEL_MEAN_BGR, device=img.device)
    return out


@torch.no_grad()
def labeled(n: int, mix: dict, gen: torch.Generator, device) -> dict:
    """A training batch as the program's train step takes it
    (``data/synthetic.py::batch_to_torch``): ``image`` f32 [n, C, C, 3]
    normalized, ``image_size`` int32 [n, 2], and up to ``max_gt`` instances
    a window: ``boxes`` f32 [n, M, 4] (x0, y0, x1, y1 of the mask's
    pixels), ``labels`` int32 (1 cytoplasm, 2 nucleus), ``gt_valid`` and
    full-canvas ``masks`` uint8 [n, M, C, C]."""
    img, masks, n_cells = _scene(n, mix, gen, device, True)
    h, w = mix["window"]
    c, m = mix["canvas"], mix["max_gt"]
    k = masks.shape[1]
    valid = (torch.arange(k, device=device)[None] < 2 * n_cells[:, None]) & masks.flatten(2).any(-1)
    rows, cols = masks.any(3), masks.any(2)  # [n, k, h], [n, k, w]
    first = lambda a: a.float().argmax(-1)  # noqa: E731
    last = lambda a: a.shape[-1] - 1 - a.flip(-1).float().argmax(-1)  # noqa: E731
    boxes = torch.stack([first(cols), first(rows), last(cols), last(rows)], -1).float()
    out_masks = torch.zeros((n, m, c, c), dtype=torch.uint8, device=device)
    out_masks[:, :k, :h, :w] = masks.to(torch.uint8)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, m - k)) if t.dim() == 3 else torch.nn.functional.pad(t, (0, m - k))  # noqa: E731
    return {
        "image": _normalized(img, c),
        "image_size": torch.tensor([[h, w]] * n, dtype=torch.int32, device=device),
        "boxes": pad(torch.where(valid[..., None], boxes, 0.0)),
        "labels": pad(torch.where(valid, (torch.arange(k, device=device) % 2 + 1)[None].expand(n, k), 0).to(torch.int32)),
        "gt_valid": pad(valid),
        "masks": out_masks,
    }


@torch.no_grad()
def unlabeled(n: int, mix: dict, gen: torch.Generator, device, aug_k: int, aug_s: int) -> dict:
    """A mean-teacher unlabeled batch (``data/synthetic.py::
    generate_unlabeled_batch``): ``t_images`` f32 [n, K, C, C, 3] and
    ``s_images`` [n, S, C, C, 3], each view the normalized window plus its
    own N(0, view_noise^2) noise, and ``image_size``."""
    img, _, _ = _scene(n, mix, gen, device, False)
    base = _normalized(img, mix["canvas"])
    sd = mix["view_noise"]
    views = lambda v: base[:, None] + sd * torch.randn((n, v, *base.shape[1:]), generator=gen, device=device)  # noqa: E731
    h, w = mix["window"]
    return {"t_images": views(aug_k), "s_images": views(aug_s),
            "image_size": torch.tensor([[h, w]] * n, dtype=torch.int32, device=device)}
