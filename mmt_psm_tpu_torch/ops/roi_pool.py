"""ROIPool, max pooling over RoI bins (the port's copy of
``mmt_psm_tpu/ops/roi_pool.py``, after the reference's ROIPool kernel,
csrc/cuda/ROIPool_cuda.cu, and its wrapper layers/roi_pool.py). No graph
calls it: the reference's Pooler builds ROIAlign only
(modeling/poolers.py:45-49). The JAX function is XLA code with no Pallas
kernel, so this is plain PyTorch.

A RoI is scaled by ``spatial_scale`` and rounded half away from zero (the
CUDA ``round``), bin edges are floor(p L / P) and ceil((p + 1) L / P) in
integers, and an empty bin gives 0. Each output is a masked maximum over
rows, then over columns, with ``amax``: its gradient splits a tie evenly
among equal maxima, as ``jnp.max``'s does (``max(dim)`` would give it all
to one index).
"""

from __future__ import annotations

import torch

# RoIs pooled at a time: bounds the [CHUNK, H, W, C] masked copies
CHUNK = 32


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _bin_edges(lo: torch.Tensor, length: torch.Tensor, p: int, pooled: int, size: int):
    """[R] start and end of bin ``p`` along one axis, clipped to [0, size]."""
    start = torch.clamp((p * length) // pooled + lo, 0, size)
    end = torch.clamp(-((-(p + 1) * length) // pooled) + lo, 0, size)
    return start, end


def _pool_chunk(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float, pooled: int) -> torch.Tensor:
    h, w = feat.shape[0], feat.shape[1]
    x1, y1, x2, y2 = (_round_half_away(rois[:, i] * spatial_scale) for i in range(4))
    x1i, y1i = x1.to(torch.int32), y1.to(torch.int32)
    roi_w = torch.clamp((x2 - x1 + 1).to(torch.int32), min=1)
    roi_h = torch.clamp((y2 - y1 + 1).to(torch.int32), min=1)
    ys = torch.arange(h, dtype=torch.int32, device=feat.device)
    xs = torch.arange(w, dtype=torch.int32, device=feat.device)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=feat.device)
    rows = []
    for ph in range(pooled):
        start, end = _bin_edges(y1i, roi_h, ph, pooled, h)
        inside = (ys[None, :] >= start[:, None]) & (ys[None, :] < end[:, None])  # [R, H]
        rows.append(torch.where(inside[:, :, None, None], feat[None], neg).amax(dim=1))  # [R, W, C]
    row_stack = torch.stack(rows, dim=1)  # [R, P, W, C]
    cols = []
    for pw in range(pooled):
        start, end = _bin_edges(x1i, roi_w, pw, pooled, w)
        inside = (xs[None, :] >= start[:, None]) & (xs[None, :] < end[:, None])  # [R, W]
        cols.append(torch.where(inside[:, None, :, None], row_stack, neg).amax(dim=2))  # [R, P, C]
    res = torch.stack(cols, dim=2)  # [R, P, P, C]
    return torch.where(torch.isfinite(res), res, torch.zeros((), dtype=res.dtype, device=res.device))


def roi_pool(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float, pooled_size: int) -> torch.Tensor:
    """features [H, W, C]; rois [N, 4] in image coordinates -> [N, P, P, C]."""
    out = [_pool_chunk(features, rois[lo : lo + CHUNK], spatial_scale, pooled_size)
           for lo in range(0, rois.shape[0], CHUNK)]
    if not out:
        return features.new_zeros((0, pooled_size, pooled_size, features.shape[-1]))
    return torch.cat(out)
