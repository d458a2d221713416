"""RPN head and test-time proposal selection (port of
``mmt_psm_tpu/models/rpn.py:41-162``).

Per image and level: top-k on the raw logits (sigmoid is monotonic, so
only the kept scores pay it), decode, clip, min-size, NMS at
``nms_thresh`` keeping ``post_nms_top_n``; then per image the top
``fpn_post_nms_top_n`` over all levels. Every (image, level) NMS of the
batch goes to one launch of kernel K1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import decode
from ..ops.nms import NEG_INF, nms_topk
from ..ops.topk import top_k
from ..structures.boxes import clip_to_image, nonempty_mask
from ..structures.detections import Proposals
from .layers import Conv2d, normal_


class RPNHead(nn.Module):
    """Single 3x3 conv shared over levels + 1x1 objectness and box heads."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = Conv2d(channels, num_anchors, 1)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1)

    def init_weights(self, gen: torch.Generator):
        for m in (self.conv, self.cls_logits, self.bbox_pred):
            normal_(m.weight, 0.01, gen)
            nn.init.zeros_(m.bias)

    def forward(self, features):
        """NHWC levels -> per level ([B, H, W, A], [B, H, W, 4A]) NHWC."""
        logits, regs = [], []
        for f in features:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1))
            regs.append(self.bbox_pred(t).permute(0, 2, 3, 1))
        return logits, regs


class RPN(nn.Module):
    """Holds the head under maskrcnn-benchmark's ``rpn.head`` prefix."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.head = RPNHead(channels, num_anchors)

    def forward(self, features):
        return self.head(features)


def select_proposals(objectness, box_regression, anchors, image_sizes, *, pre_nms_top_n: int,
                     post_nms_top_n: int, fpn_post_nms_top_n: int, nms_thresh: float,
                     min_size: float) -> Proposals:
    """objectness/box_regression: per level NHWC [B, H, W, A(*4)];
    anchors: per level f32 [H*W*A, 4]; image_sizes int [B, 2] (h, w)."""
    b = image_sizes.shape[0]
    hh = image_sizes[:, 0:1]
    ww = image_sizes[:, 1:2]
    per_level = []
    for obj_l, reg_l, anc_l in zip(objectness, box_regression, anchors):
        logits = obj_l.reshape(b, -1).float()
        deltas = reg_l.reshape(b, -1, 4)
        k = min(pre_nms_top_n, logits.shape[1])
        top_logits, top_idx = top_k(logits, k)
        scores = torch.sigmoid(top_logits)
        top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4)).float()
        boxes = decode(top_deltas, anc_l[top_idx])
        boxes = clip_to_image(boxes, hh, ww)
        per_level.append((boxes, scores, nonempty_mask(boxes, min_size)))

    # one NMS launch over every (level, image): pad the levels to one length
    # with invalid rows, which sort last and never suppress or survive
    kmax = max(p[1].shape[1] for p in per_level)
    boxes_all = torch.cat([F.pad(p[0], (0, 0, 0, kmax - p[0].shape[1])) for p in per_level])
    scores_all = torch.cat([F.pad(p[1], (0, kmax - p[1].shape[1])) for p in per_level])
    valid_all = torch.cat([F.pad(p[2], (0, kmax - p[2].shape[1])) for p in per_level])
    keep_idx, keep_valid = nms_topk(boxes_all, scores_all, valid_all, nms_thresh, post_nms_top_n)

    out_b, out_s, out_v = [], [], []
    for lvl, (boxes, scores, _) in enumerate(per_level):
        idx = keep_idx[lvl * b:(lvl + 1) * b]
        v = keep_valid[lvl * b:(lvl + 1) * b]
        k = boxes.shape[1]
        if k < post_nms_top_n:
            # the JAX per-level top-k pads slots past k with index 0
            idx = torch.where(torch.arange(post_nms_top_n, device=idx.device) < k, idx, 0)
        out_b.append(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)))
        out_s.append(torch.gather(scores, 1, idx))
        out_v.append(v)
    boxes = torch.cat(out_b, 1)
    scores = torch.cat(out_s, 1)
    valid = torch.cat(out_v, 1)

    k_out = min(fpn_post_nms_top_n, scores.shape[1])
    top_scores, top_idx = top_k(torch.where(valid, scores, NEG_INF), k_out)
    out_valid = top_scores > NEG_INF / 2
    return Proposals(
        boxes=torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(out_valid, top_scores, 0.0),
        valid=out_valid,
    )
