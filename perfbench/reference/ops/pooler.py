"""Multi-level FPN ROIAlign: a frozen copy of the program's ``ops/pooler.py``
with only its plain versions, forward and backward, on any device.

Each RoI gets an FPN level by eq.(1) of the FPN paper,
lvl = floor(4 + log2(sqrt(area)/224 + 1e-6)) clamped to the pyramid, and
is pooled on that level with Caffe2's ROIAlign (aligned=False): sample
``start + p*bin + (i+0.5)*bin/G`` per axis, 0 outside [-1, dim], clamp at
0, collapse onto the last row/column at the edge, mean over the G*G
samples of a bin. Feature maps are NHWC ``[B, H_l, W_l, C]``; pooled
features come out ``[B, N, P, P, C]`` in the feature dtype, accumulated in
float32. The boxes get no gradient.
"""

from __future__ import annotations

import math

import torch

from ..structures.boxes import box_area

_PLAIN_ROI_CHUNK = 256


def _div(x, d: float):
    """x / d rounded as a true division. PyTorch's CUDA kernels turn a
    division by a Python scalar into a multiplication by its reciprocal,
    which can move a sample coordinate by an ulp; a tensor divisor keeps
    the CPU's, the JAX package's and kernel K2's rounding."""
    return x / torch.full_like(x, d)


def assign_levels(boxes, k_min: int, k_max: int, canonical_scale: int = 224, canonical_level: int = 4, eps: float = 1e-6):
    """FPN eq.(1) level ids, 0-based from k_min (int32, same shape as boxes[..., 0])."""
    s = torch.sqrt(box_area(boxes))
    lvl = torch.floor(canonical_level + torch.log2(_div(s, canonical_scale) + eps))
    lvl = lvl.clamp(k_min, k_max)
    return (lvl - k_min).to(torch.int32)


def _levels(boxes, scales):
    k_min = int(-math.log2(scales[0]))
    k_max = int(-math.log2(scales[-1]))
    # clamp again after the int cast: a NaN box must not index past the pyramid
    return assign_levels(boxes, k_min, k_max).clamp(0, len(scales) - 1)


def _axis_samples(start, size, pooled: int, grid: int, dim):
    """Per-RoI sample corners and weights along one axis.

    start/size/dim: f32 [R]. Returns (low, high) int64 [R, P*G] and
    (w_low, w_high) f32 [R, P*G], the weights already carrying the
    in-bounds test and the 1/G of the bin mean.
    """
    dev = start.device
    bin_size = _div(size, pooled)
    p = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(grid, dtype=torch.float32, device=dev)[None, None, :]
    b = bin_size[:, None, None]
    coord = start[:, None, None] + p * b + _div((i + 0.5) * b, grid)  # [R, P, G]
    d = dim[:, None, None]
    inb = (coord >= -1.0) & (coord <= d)
    c = coord.clamp(min=0.0)
    low = torch.floor(c)
    at_edge = low >= d - 1
    low = torch.where(at_edge, d - 1.0, low)
    frac = torch.where(at_edge, 0.0, c - low)
    high = torch.where(at_edge, low, low + 1.0)
    w_low = _div(torch.where(inb, 1.0 - frac, 0.0), grid)
    w_high = _div(torch.where(inb, frac, 0.0), grid)
    r = start.shape[0]
    flat = (r, pooled * grid)
    return (low.long().reshape(flat), high.long().reshape(flat),
            w_low.reshape(flat), w_high.reshape(flat))


def multilevel_roi_align_plain(features, boxes, scales, output_size: int, sampling_ratio: int):
    """Plain PyTorch version of kernel K2, on any device.

    Gathers the four bilinear corners of every sample from the RoI's own
    level, so it is exact for any RoI size. RoIs go in chunks of
    ``_PLAIN_ROI_CHUNK`` to bound the gathered [chunk, P*G, P*G, C] f32 buffer.
    """
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    dev = boxes.device
    pooled, grid = output_size, sampling_ratio
    levels = _levels(boxes, scales).reshape(-1).long()
    img = torch.arange(b, device=dev).repeat_interleave(n)
    boxes = boxes.reshape(-1, 4).float()

    table = torch.cat([f.reshape(-1, c) for f in features])  # all levels' cells
    hs, ws, offs, sc = _level_tables([f.shape for f in features], scales, dev)

    out = []
    for lo in range(0, b * n, _PLAIN_ROI_CHUNK):
        sl = slice(lo, min(lo + _PLAIN_ROI_CHUNK, b * n))
        acc = 0.0
        for idx, wt in _chunk_samples(boxes, levels, img, sl, hs, ws, offs, sc, pooled, grid):
            acc = acc + wt[..., None] * table[idx].float()  # [r, Sy, Sx, C]
        r = acc.shape[0]
        acc = acc.reshape(r, pooled, grid, pooled, grid, c).sum(dim=(2, 4))
        out.append(acc.to(dtype))
    return torch.cat(out).reshape(b, n, pooled, pooled, c)


def _chunk_samples(boxes, levels, img, sl, hs, ws, offs, sc, pooled: int, grid: int):
    """Flat table rows [r, Sy, Sx] of the four bilinear corners of every
    sample of the RoIs in ``sl``, with their weights (f32 [r, Sy, Sx])."""
    lv, bx = levels[sl], boxes[sl]
    h, w, s = hs[lv], ws[lv], sc[lv]
    start_x, start_y = bx[:, 0] * s, bx[:, 1] * s
    roi_w = (bx[:, 2] * s - start_x).clamp(min=1.0)
    roi_h = (bx[:, 3] * s - start_y).clamp(min=1.0)
    y_lo, y_hi, wy_lo, wy_hi = _axis_samples(start_y, roi_h, pooled, grid, h.float())
    x_lo, x_hi, wx_lo, wx_hi = _axis_samples(start_x, roi_w, pooled, grid, w.float())
    base = (offs[lv] + img[sl] * h * w)[:, None, None]
    for yy, wy in ((y_lo, wy_lo), (y_hi, wy_hi)):
        for xx, wx in ((x_lo, wx_lo), (x_hi, wx_hi)):
            yield base + (yy * w[:, None])[:, :, None] + xx[:, None, :], wy[:, :, None] * wx[:, None, :]


def _level_tables(shapes, scales, dev):
    hs = torch.tensor([s[1] for s in shapes], device=dev)
    ws = torch.tensor([s[2] for s in shapes], device=dev)
    offs = torch.tensor([0] + [s[0] * s[1] * s[2] for s in shapes[:-1]], device=dev).cumsum(0)
    return hs, ws, offs, torch.tensor(scales, dtype=torch.float32, device=dev)


def multilevel_roi_align_backward_plain(grad, boxes, shapes, scales, output_size: int, sampling_ratio: int):
    """Plain PyTorch version of kernel K3, on any device: the transpose of
    ``multilevel_roi_align_plain``.

    grad [B, N, P, P, C]; shapes the per-level map shapes [B, H_l, W_l, C].
    Every sample scatters (wy * wx) * g into its four corners with
    ``index_add_`` into one float32 table of all levels' cells, which is
    rounded to the cotangent's dtype at the end.
    Returns one gradient map per level.
    """
    b, n = boxes.shape[:2]
    c = shapes[0][-1]
    dev = boxes.device
    pooled, grid = output_size, sampling_ratio
    levels = _levels(boxes, scales).reshape(-1).long()
    img = torch.arange(b, device=dev).repeat_interleave(n)
    boxes = boxes.reshape(-1, 4).float()
    hs, ws, offs, sc = _level_tables(shapes, scales, dev)
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    table = torch.zeros(sum(sizes), c, dtype=torch.float32, device=dev)
    g = grad.reshape(b * n, pooled, pooled, c).float()
    for lo in range(0, b * n, _PLAIN_ROI_CHUNK):
        sl = slice(lo, min(lo + _PLAIN_ROI_CHUNK, b * n))
        # each sample carries its bin's cotangent: [r, P*G, P*G, C]
        gs = g[sl].repeat_interleave(grid, dim=1).repeat_interleave(grid, dim=2)
        for idx, wt in _chunk_samples(boxes, levels, img, sl, hs, ws, offs, sc, pooled, grid):
            table.index_add_(0, idx.reshape(-1), (wt[..., None] * gs).reshape(-1, c))
    return [t.reshape(s).to(grad.dtype) for t, s in zip(table.split(sizes), shapes)]


class _MultilevelRoIAlign(torch.autograd.Function):
    """The plain forward and its exact transpose, on any device."""

    @staticmethod
    def forward(ctx, boxes, scales, output_size, sampling_ratio, *features):
        ctx.save_for_backward(boxes)
        ctx.args = (tuple(tuple(f.shape) for f in features), scales, output_size, sampling_ratio)
        return multilevel_roi_align_plain(features, boxes, scales, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        grads = multilevel_roi_align_backward_plain(grad, boxes, *ctx.args)
        return (None, None, None, None, *grads)


def multilevel_roi_align(features, boxes, scales, output_size: int, sampling_ratio: int):
    """Pool boxes [B, N, 4] from per-level NHWC maps -> [B, N, P, P, C],
    differentiable in the maps."""
    return _MultilevelRoIAlign.apply(boxes, tuple(scales), output_size, sampling_ratio, *features)
