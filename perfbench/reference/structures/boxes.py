"""Fixed-shape box geometry on ``[..., N, 4]`` xyxy tensors.

Port of ``mmt_psm_tpu/structures/boxes.py``. The reference's "+1" pixel
convention holds throughout: area = (x2-x1+1)(y2-y1+1), IoU with +1
widths, clip to [0, size-1] (maskrcnn_benchmark bounding_box.py and
boxlist_ops.py). The operation order follows the JAX functions so that
float32 results agree bit for bit.
"""

from __future__ import annotations

import torch

TO_REMOVE = 1.0


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., N, M]``: inter / max(a1 + a2 - inter, 1e-10)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def clip_to_image(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp coords into [0, size-1]. ``height``/``width`` are numbers or
    tensors broadcastable against ``boxes[..., 0]``."""
    hmax = height - TO_REMOVE
    wmax = width - TO_REMOVE
    x1 = _clamp(boxes[..., 0], wmax)
    y1 = _clamp(boxes[..., 1], hmax)
    x2 = _clamp(boxes[..., 2], wmax)
    y2 = _clamp(boxes[..., 3], hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _clamp(x: torch.Tensor, hi) -> torch.Tensor:
    # jnp.clip(x, 0, hi) == min(max(x, 0), hi)
    x = x.clamp(min=0.0)
    if isinstance(hi, torch.Tensor):
        return torch.minimum(x, hi.to(x.dtype))
    return x.clamp(max=float(hi))


def nonempty_mask(boxes: torch.Tensor, min_size: float = 0.0) -> torch.Tensor:
    """True where both sides (with +1) are >= min_size."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (w >= min_size) & (h >= min_size)


def hflip_boxes(boxes: torch.Tensor, width) -> torch.Tensor:
    """Horizontal flip in a canvas ``width`` wide, +1 convention
    (reference bounding_box.py:149-151)."""
    x1 = width - boxes[..., 2] - TO_REMOVE
    x2 = width - boxes[..., 0] - TO_REMOVE
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)
