"""Bytes and operations that the kernel roles' work needs, from each call's
logical inputs, and the least time the chip could take for them.

Copies of ``chip_smoke.py``'s ``bound``, ``sampled_cells`` and the byte and
operation counts of its ``time_nms``, ``time_roi_align`` and
``check_roi_align_backward``, written per call so that they read the same
work whatever kernel implements the role:

* K1, greedy NMS on score-sorted problems: each kept box tested against
  every later box (14 operations an IoU test); boxes, valid flags and the
  threshold read once, the flags written once.
* K2, multi-level ROIAlign forward: the distinct feature cells the RoIs'
  samples touch read once, boxes and levels read once, the pooled features
  written once; 4 samples x (4 corner multiply-adds + 2 row weights) an
  output element.
* K3, its backward: the cotangent, boxes and levels read once, every cell
  of the gradient maps written once; 4 samples x 4 corners x (multiply,
  add) a cotangent element.
"""

from __future__ import annotations

import json
import math
import os

import torch

from ..reference.ops import pooler as Pm

PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")))


def bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` and float32 ``ops``, and which bounds it."""
    t_bytes, t_ops = nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["f32_ops_per_s"]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations")


def k1_nms(boxes_s: torch.Tensor, valid_s: torch.Tensor, supp: torch.Tensor) -> tuple:
    """(bytes, operations) of one K1 call on score-sorted boxes [P, N, 4],
    valid [P, N] and its suppression flags [P, N]."""
    n = boxes_s.shape[1]
    kept = (~supp & valid_s).float()
    pairs = float((kept * (n - 1 - torch.arange(n, device=kept.device))).sum())
    nbytes = boxes_s.numel() * 4 + valid_s.numel() + boxes_s.shape[0] * 4 + valid_s.numel()
    return nbytes, 14.0 * pairs


def sampled_cells(feats, boxes, scales, p: int, g: int) -> int:
    """Distinct (level, image, y, x) cells whose value some RoI's samples
    weigh in (the pooler's own sample arithmetic): what ROIAlign must read.
    ``feats`` may be the maps or their shapes [B, H, W, C]."""
    b, n = boxes.shape[:2]
    levels = Pm._levels(boxes, scales).reshape(-1)
    img = torch.arange(b, device=boxes.device).repeat_interleave(n)
    bx = boxes.reshape(-1, 4).float()
    cells = 0
    for lv, (f, sc) in enumerate(zip(feats, scales)):
        sel = levels == lv
        r, h, w = int(sel.sum()), f[1] if isinstance(f, tuple) else f.shape[1], f[2] if isinstance(f, tuple) else f.shape[2]
        if r == 0:
            continue
        x0, y0 = bx[sel, 0] * sc, bx[sel, 1] * sc
        rw, rh = (bx[sel, 2] * sc - x0).clamp(min=1.0), (bx[sel, 3] * sc - y0).clamp(min=1.0)
        ylo, yhi, wylo, wyhi = Pm._axis_samples(y0, rh, p, g, torch.full((r,), float(h), device=boxes.device))
        xlo, xhi, wxlo, wxhi = Pm._axis_samples(x0, rw, p, g, torch.full((r,), float(w), device=boxes.device))
        ys, ym = torch.cat([ylo, yhi], 1), torch.cat([wylo > 0, wyhi > 0], 1)
        xs, xm = torch.cat([xlo, xhi], 1), torch.cat([wxlo > 0, wxhi > 0], 1)
        flat = (img[sel] * h * w)[:, None, None] + (ys * w)[:, :, None] + xs[:, None, :]
        occ = torch.zeros(b * h * w, dtype=torch.bool, device=boxes.device)
        occ[flat[ym[:, :, None] & xm[:, None, :]]] = True
        cells += int(occ.sum())
    return cells


def k2_roi_align(shapes, boxes: torch.Tensor, scales, p: int, g: int, elem_bytes: int) -> tuple:
    """(bytes, operations) of one K2 call pooling ``boxes`` [B, N, 4] at
    P = ``p`` from maps of ``shapes`` [(B, H, W, C), ...]."""
    c = shapes[0][3]
    out_elems = boxes.shape[0] * boxes.shape[1] * p * p * c
    nbytes = sampled_cells(shapes, boxes, scales, p, g) * c * elem_bytes + boxes.numel() * 5 + out_elems * elem_bytes
    return nbytes, out_elems * 4 * (4 * 2 + 2)


def k3_roi_align_bwd(shapes, boxes: torch.Tensor, p: int, elem_bytes: int) -> tuple:
    """(bytes, operations) of one K3 call: a cotangent [B, N, P, P, C] of
    ``boxes`` back onto maps of ``shapes``."""
    c = shapes[0][3]
    g_elems = boxes.shape[0] * boxes.shape[1] * p * p * c
    nbytes = g_elems * elem_bytes + boxes.numel() * 5 + sum(math.prod(sh) for sh in shapes) * elem_bytes
    return nbytes, g_elems * 4 * (4 * 2)
