"""RPN head, proposal selection and loss (port of
``mmt_psm_tpu/models/rpn.py:41-226``).

Per image and level: top-k on the raw logits (sigmoid is monotonic, so
only the kept scores pay it), decode, clip, min-size, NMS at
``nms_thresh`` keeping ``post_nms_top_n``; then across levels the top
``fpn_post_nms_top_n``, per image at test time and over the whole batch
in training (the reference's quirk: FPN_POST_NMS_TOP_N_TRAIN counts per
batch), with the gt boxes appended at score 1. Every (image, level) NMS of
the batch goes to one launch of kernel K1.

The loss matches anchors to gt (0.7/0.3, low-quality matches kept),
ignores anchors that straddle the image or fall between the thresholds,
samples 256 per image at half positives and takes the objectness BCE and
the smooth-L1 (beta 1/9) box loss over the sampled count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses as L
from ..ops.box_coder import decode, encode
from ..ops.matcher import BETWEEN_THRESHOLDS, match
from ..ops.nms import NEG_INF, nms_topk
from ..ops.sampler import sample
from ..ops.topk import top_k
from .. import comm
from ..structures.boxes import box_iou, clip_to_image, nonempty_mask
from ..structures.detections import GroundTruth, Proposals
from .anchors import visibility
from .layers import Conv2d, normal_


class RPNHead(nn.Module):
    """Single 3x3 conv shared over levels + 1x1 objectness and box heads."""

    def __init__(self, channels: int = 256, num_anchors: int = 3, in_channels: int | None = None):
        super().__init__()
        self.conv = Conv2d(in_channels or channels, channels, 3, padding=1)
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

    def __init__(self, channels: int = 256, num_anchors: int = 3, in_channels: int | None = None):
        super().__init__()
        self.head = RPNHead(channels, num_anchors, in_channels)

    def forward(self, features):
        return self.head(features)


def select_proposals(objectness, box_regression, anchors, image_sizes, *, pre_nms_top_n: int,
                     post_nms_top_n: int, fpn_post_nms_top_n: int, nms_thresh: float,
                     min_size: float, is_train: bool = False, gt: GroundTruth | None = None) -> Proposals:
    """objectness/box_regression: per level NHWC [B, H, W, A(*4)];
    anchors: per level f32 [H*W*A, 4]; image_sizes int [B, 2] (h, w).
    Pass detached head outputs in training: no gradient flows here."""
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
    masked = torch.where(valid, scores, NEG_INF)
    if is_train:
        # the k_out best over the whole batch, compacted into each image's first slots
        flat = masked.reshape(-1)
        kth = comm.global_kth(flat, min(k_out, comm.global_rows(flat.shape[0])))
        masked = torch.where(valid & (masked >= kth), scores, NEG_INF)
    top_scores, top_idx = top_k(masked, k_out)
    out_valid = top_scores > NEG_INF / 2
    out_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    out_scores = torch.where(out_valid, top_scores, 0.0)
    if is_train and gt is not None:
        out_boxes = torch.cat([out_boxes, gt.boxes.to(out_boxes.dtype)], 1)
        out_scores = torch.cat([out_scores, gt.valid.to(out_scores.dtype)], 1)
        out_valid = torch.cat([out_valid, gt.valid], 1)
    return Proposals(boxes=out_boxes, scores=out_scores, valid=out_valid)


def _prepare_targets(anchors_all, vis, gt_boxes, gt_valid, fg_thresh: float, bg_thresh: float):
    """Anchor labels (1, 0, -1 ignore) [B, A] and regression targets [B, A, 4]."""
    quality = box_iou(gt_boxes, anchors_all)  # [B, M, A]
    matched = match(quality, gt_valid, fg_thresh, bg_thresh, allow_low_quality_matches=True)
    labels = (matched >= 0).long()
    labels = torch.where(vis, labels, -1)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    matched_gt = torch.gather(gt_boxes, 1, matched.clamp(min=0)[..., None].expand(-1, -1, 4))
    return labels, encode(matched_gt, anchors_all)


def rpn_loss(r, objectness, box_regression, anchors, image_sizes, gt: GroundTruth, *, fg_thresh: float = 0.7,
             bg_thresh: float = 0.3, batch_per_image: int = 256, positive_fraction: float = 0.5,
             straddle_thresh: float = 0.0):
    """(objectness loss, box loss). r f32 [B, A_total]: the sampler's draws."""
    b = image_sizes.shape[0]
    anchors_all = torch.cat(list(anchors))  # [A, 4]
    obj = torch.cat([o.reshape(b, -1) for o in objectness], 1).float()  # [B, A]
    reg = torch.cat([x.reshape(b, -1, 4) for x in box_regression], 1).float()  # [B, A, 4]
    vis = visibility(anchors_all, image_sizes[:, 0:1], image_sizes[:, 1:2], straddle_thresh)
    labels, targets = _prepare_targets(anchors_all, vis, gt.boxes, gt.valid, fg_thresh, bg_thresh)
    idx, is_pos, valid = sample(r, labels, batch_per_image, positive_fraction)
    s_obj = torch.gather(obj, 1, idx)
    s_lab = torch.gather(labels, 1, idx).float()
    idx4 = idx[..., None].expand(-1, -1, 4)
    box_num = L.smooth_l1_sum(torch.gather(reg, 1, idx4), torch.gather(targets, 1, idx4), beta=1.0 / 9,
                              weight=is_pos.float()[..., None])
    obj_num = (valid.float() * L.bce_with_logits(s_obj, s_lab)).sum()
    total = comm.global_sum(valid.float().sum()).clamp(min=1.0)
    return obj_num / total, box_num / total
