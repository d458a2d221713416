"""Fixed-shape greedy NMS over batches of independent problems.

Port of ``mmt_psm_tpu/ops/nms.py``. Boxes are sorted by score (stable,
so ties keep index order) and the suppression flags of the sorted boxes
come from kernel K1 (``csrc/nms.cu``) for CUDA tensors, or from
``suppress_plain``, the sequential greedy scan, for CPU tensors. Semantics
are the reference's: +1 area, suppress when IoU >= threshold, invalid rows
are never kept and never suppress.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..structures.boxes import box_iou
from . import kernels
from .topk import top_k

NEG_INF = -1e30
# the most boxes a problem of K1 may hold: its scan stages two runs of
# 64 x ceil(N/64) suppression words in the 227 KB of shared memory a block
# may have (``csrc/nms.cu``)
MAX_KERNEL_BOXES = 14144


def suppress_plain(boxes_s: torch.Tensor, valid_s: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Greedy suppression flags [P, N] for score-sorted boxes [P, N, 4]."""
    p, n = valid_s.shape
    hit = box_iou(boxes_s, boxes_s) >= thr[:, None, None]  # [P, N, N]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes_s.device).triu(1)
    hit &= later
    supp = torch.zeros(p, n, dtype=torch.bool, device=boxes_s.device)
    for i in range(n):
        alive = ~supp[:, i] & valid_s[:, i]
        supp |= hit[:, i, :] & alive[:, None]
    return supp


def kernel_scratch(p: int, n: int, device) -> torch.Tensor:
    """K1's scratch for ``p`` problems of ``n`` boxes: the upper triangle of
    64 x 64 suppression blocks, 64 words each, row block after row block."""
    words = (n + 63) // 64
    return torch.empty((p, words * (words + 1) // 2, 64), dtype=torch.int64, device=device)


def suppress_cuda(boxes_s: torch.Tensor, valid_s: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Kernel K1: the same flags as ``suppress_plain``, on the card."""
    # the whole wrapper, checks to launch, as one span of the trace (perfbench's host_ms)
    with record_function("k1_nms"):
        if boxes_s.dim() != 3 or boxes_s.shape[-1] != 4 or boxes_s.dtype != torch.float32:
            raise ValueError(f"boxes must be f32 [P, N, 4], got {boxes_s.dtype} {tuple(boxes_s.shape)}")
        p, n = boxes_s.shape[:2]
        if valid_s.shape != (p, n) or valid_s.dtype != torch.bool:
            raise ValueError(f"valid must be bool [{p}, {n}], got {valid_s.dtype} {tuple(valid_s.shape)}")
        if thr.shape != (p,) or thr.dtype != torch.float32:
            raise ValueError(f"thresholds must be f32 [{p}], got {thr.dtype} {tuple(thr.shape)}")
        dev = boxes_s.device
        if not (valid_s.device == dev == thr.device):
            raise ValueError("boxes, valid and thresholds must be on one device")
        if n > MAX_KERNEL_BOXES:
            raise ValueError(f"K1 takes at most {MAX_KERNEL_BOXES} boxes a problem, got {n}")
        boxes_s, valid_s, thr = boxes_s.contiguous(), valid_s.contiguous(), thr.contiguous()
        lib = kernels.library("nms")
        scratch = kernel_scratch(p, n, dev)
        supp = torch.empty((p, n), dtype=torch.bool, device=dev)  # the kernel writes 0 or 1
        with torch.cuda.device(dev):
            err = lib.nms_suppress(
                boxes_s.data_ptr(), valid_s.data_ptr(), thr.data_ptr(), scratch.data_ptr(),
                supp.data_ptr(), p, n, kernels.stream_handle(dev),
            )
        kernels.check(err, "nms_suppress")
        suppress_cuda.launches += 1
        return supp


suppress_cuda.launches = 0


def _thresholds(iou_threshold, p: int, device) -> torch.Tensor:
    if isinstance(iou_threshold, torch.Tensor):
        return iou_threshold.to(torch.float32)
    # a fill, not a host->device copy: no sync on the card
    return torch.full((p,), float(iou_threshold), dtype=torch.float32, device=device)


def _nms_mask(boxes, scores, valid, iou_threshold, suppress):
    p = boxes.shape[0]
    order = torch.argsort(-torch.where(valid, scores, NEG_INF), dim=-1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    supp = suppress(boxes_s, valid_s, _thresholds(iou_threshold, p, boxes.device))
    keep_sorted = ~supp & valid_s
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def nms_mask(boxes, scores, valid, iou_threshold) -> torch.Tensor:
    """Exact greedy NMS keep-mask [P, N] in the original box order.

    boxes f32 [P, N, 4] xyxy; scores f32 [P, N]; valid bool [P, N];
    iou_threshold a float or an f32 tensor [P] (one per problem). Runs
    kernel K1 on CUDA tensors and the plain scan on CPU tensors.
    """
    if boxes.is_cuda:
        return _nms_mask(boxes, scores, valid, iou_threshold, suppress_cuda)
    if boxes.device.type == "cpu":
        return _nms_mask(boxes, scores, valid, iou_threshold, suppress_plain)
    raise ValueError(f"nms_mask: unsupported device {boxes.device}")


def nms_mask_plain(boxes, scores, valid, iou_threshold) -> torch.Tensor:
    """``nms_mask`` through the plain scan on any device (the kernel's reference)."""
    return _nms_mask(boxes, scores, valid, iou_threshold, suppress_plain)


def nms_topk(boxes, scores, valid, iou_threshold, max_out: int):
    """NMS keeping the top ``max_out`` survivors of each problem in score order.

    Returns (indices int64 [P, max_out], valid_out bool [P, max_out]);
    padding slots hold index 0 with valid_out False, as in the JAX
    ``nms_topk``.
    """
    keep = nms_mask(boxes, scores, valid, iou_threshold)
    kept = torch.where(keep, scores, NEG_INF)
    k = min(max_out, boxes.shape[1])
    top_scores, top_idx = top_k(kept, k)
    if k < max_out:
        pad = max_out - k
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=NEG_INF)
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))
    return top_idx, top_scores > NEG_INF / 2
