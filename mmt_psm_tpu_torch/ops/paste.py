"""Mask pasting onto a canvas (port of ``mmt_psm_tpu/ops/paste.py:24-85``).

The device-side form of the reference Masker paste (maskrcnn_benchmark/
modeling/roi_heads/mask_head/inference.py:169-246): each RoI's 28x28
probability map is bilinearly resized to its box extent (w = x2-x1+1),
thresholded at 0.5 and summed into a canvas. Instead of a resize per box,
the bilinear sample is evaluated at every canvas pixel, on fixed shapes
with no host sync. ``paste_integral`` gives the mean teacher's MGD
"integral foreground mask" (generalized_rcnn.py:129-131) at a reduced
canvas resolution; ``paste_masks`` gives each RoI's pasted probabilities
(the Masker of a graph with POSTPROCESS_MASKS; the engine pastes on the
host instead, ``engine/paste.py``). Plain PyTorch: the JAX functions are
XLA code, with no Pallas kernel.
"""

from __future__ import annotations

import torch

# the reference Masker's threshold on pasted probabilities
THRESHOLD = 0.5
# RoIs sampled at a time: bounds the [CHUNK, out, out] samples
CHUNK = 32


def _interp_1d(c: torch.Tensor, m: int):
    c = c.clamp(0.0, m - 1.0)
    lo = torch.floor(c)
    frac = c - lo
    lo = lo.long()
    return lo, (lo + 1).clamp(max=m - 1), frac


def _sample(mask: torch.Tensor, box: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of R RoI masks at canvas image coordinates.

    mask f32 [R, M, M]; box [R, 4]; ys/xs f32 [H]/[W]. Returns [R, H, W]
    probabilities, 0 outside each box. The arithmetic is the JAX
    ``_sample_one``'s, in its order: along x first, then along y."""
    m = mask.shape[-1]
    x0, y0, x1, y1 = (box[:, i:i + 1] for i in range(4))
    w = x1 - x0 + 1.0
    h = y1 - y0 + 1.0
    # image coordinate -> mask coordinate (torch interpolate's resize)
    u = (xs[None, :] - x0 + 0.5) / w * m - 0.5  # [R, W]
    v = (ys[None, :] - y0 + 0.5) / h * m - 0.5  # [R, H]
    inside_x = (xs[None, :] >= x0 - 0.5) & (xs[None, :] <= x1 + 0.5)
    inside_y = (ys[None, :] >= y0 - 0.5) & (ys[None, :] <= y1 + 0.5)
    vy_lo, vy_hi, fy = _interp_1d(v, m)
    ux_lo, ux_hi, fx = _interp_1d(u, m)
    cols = lambda i: torch.gather(mask, 2, i[:, None, :].expand(-1, m, -1))  # noqa: E731  [R, M, W]
    along_x = cols(ux_lo) * (1 - fx)[:, None, :] + cols(ux_hi) * fx[:, None, :]
    rows = lambda i: torch.gather(along_x, 1, i[:, :, None].expand(-1, -1, along_x.shape[-1]))  # noqa: E731
    out = rows(vy_lo) * (1 - fy)[:, :, None] + rows(vy_hi) * fy[:, :, None]
    return out * inside_y[:, :, None] * inside_x[:, None, :]


def paste_integral(masks, boxes, valid, out_size: int, stride: float) -> torch.Tensor:
    """Per-image sum of thresholded pasted instance masks on an
    [out, out] canvas.

    masks [..., K, M, M] probabilities; boxes [..., K, 4] image
    coordinates; valid [..., K]. Canvas pixel (i, j) sits at image
    coordinate ((i + 0.5) * stride - 0.5). Returns f32 [..., out, out].
    Probabilities count from ``THRESHOLD`` on; RoIs go ``CHUNK`` at a time
    (a fixed loop, no host sync)."""
    lead, k, m = masks.shape[:-3], masks.shape[-3], masks.shape[-1]
    dev = masks.device
    masks = masks.reshape(-1, k, m, m).float()
    boxes = boxes.reshape(-1, k, 4).float()
    valid = valid.reshape(-1, k).float()
    b = masks.shape[0]
    ys = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * stride - 0.5
    out = torch.zeros(b, out_size, out_size, dtype=torch.float32, device=dev)
    for lo in range(0, k, CHUNK):
        sl = slice(lo, min(lo + CHUNK, k))
        r = masks[:, sl].shape[1]
        s = _sample(masks[:, sl].reshape(b * r, m, m), boxes[:, sl].reshape(b * r, 4), ys, ys)
        hit = (s >= THRESHOLD).float() * valid[:, sl].reshape(b * r, 1, 1)
        out += hit.reshape(b, r, out_size, out_size).sum(1)
    return out.reshape(*lead, out_size, out_size)


def paste_masks(masks, boxes, valid, out_size: int, stride: float = 1.0) -> torch.Tensor:
    """Each RoI's pasted probabilities f32 [K, out, out], neither thresholded
    nor summed: masks [K, M, M], boxes [K, 4] image coordinates, valid [K]
    (an invalid RoI's map is 0)."""
    ys = (torch.arange(out_size, dtype=torch.float32, device=masks.device) + 0.5) * stride - 0.5
    return _sample(masks.float(), boxes.float(), ys, ys) * valid.float()[:, None, None]
