"""RoI box head (port of ``mmt_psm_tpu/models/box_head.py``).

FPN2MLPFeatureExtractor (fc6/fc7 over 7x7 pooled features, dropout after
each in training) and FPNPredictor (class logits, per-class box deltas);
in training, ``subsample_proposals`` matches proposals to gt (0.5/0.5)
and samples 512 per image at a quarter positives, and ``box_head_loss``
takes the cross entropy and the class-sliced smooth-L1 (beta 1) over the
sampled count. Without relation-NMS, ``postprocess_boxes`` turns the
head's outputs into detections (the reference's PostProcessor): per class,
score above 0.05, greedy NMS at 0.5 through one K1 launch for every (image,
class) problem, then the best 200 over the classes; or, for set-NMS, the
best of each class tagged with their proposal, which ``set_nms_filter``
filters on the host. ``fc6.weight`` keeps the reference's layout, whose input
index runs over (C, H, W); the port flattens pooled features in the JAX
order (H, W, C), so the forward permutes the weight's input axis, which
it casts anyway, instead of copying the activations. The JAX
``pool_boxes_batched`` is ``ops.pooler.multilevel_roi_align`` here, which
takes the batch itself.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses as L
from ..parallel import comm
from ..ops.box_coder import decode, encode
from ..ops.matcher import BETWEEN_THRESHOLDS, match
from ..ops.nms import NEG_INF, nms_topk
from ..ops.sampler import sample
from ..ops.topk import top_k
from ..structures.boxes import box_iou, clip_to_image
from ..structures.detections import Detections, GroundTruth, Proposals
from .layers import Linear, normal_, variance_scaling_


def dropout(x, p: float, gen: torch.Generator, views: int = 1):
    """flax's ``Dropout``: keep with probability 1-p, scale kept values by
    1/(1-p), the mask drawn from ``gen``. x's rows are ``views`` stacked
    groups of this rank's RoIs; under data parallelism the mask of the
    global batch is drawn and the rank keeps its rows of each group."""
    u = torch.rand((comm.global_rows(x.shape[0]), *x.shape[1:]), generator=gen, device=x.device)
    keep = comm.rank_rows(u, groups=views) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class FPN2MLPExtractor(nn.Module):
    def __init__(self, in_channels: int = 256, resolution: int = 7, mlp_dim: int = 1024, dropout: float = 0.0):
        super().__init__()
        self.in_channels, self.resolution, self.dropout = in_channels, resolution, dropout
        self.fc6 = Linear(in_channels * resolution**2, mlp_dim)
        self.fc7 = Linear(mlp_dim, mlp_dim)

    def init_weights(self, gen: torch.Generator):
        for m in (self.fc6, self.fc7):
            variance_scaling_(m.weight, 1.0 / 3, "fan_in", "uniform", gen)
            nn.init.zeros_(m.bias)

    def forward(self, pooled, gen: torch.Generator | None = None, views: int = 1):
        """pooled [N, P, P, C] -> [N, mlp_dim]. In training mode with a
        dropout rate, ``gen`` draws the dropout masks (N holds ``views``
        stacked groups of the batch's RoIs)."""
        c, p = self.in_channels, self.resolution
        drop = self.training and self.dropout > 0
        if drop and gen is None:
            raise ValueError("train-mode dropout needs a generator")
        w6 = self.fc6.weight.reshape(-1, c, p, p).permute(0, 2, 3, 1).reshape(-1, p * p * c)
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(F.linear(x, w6.to(x.dtype), self.fc6.bias.to(x.dtype)))
        if drop:
            x = dropout(x, self.dropout, gen, views)
        x = F.relu(self.fc7(x))
        return dropout(x, self.dropout, gen, views) if drop else x


class FPNPredictor(nn.Module):
    def __init__(self, in_dim: int = 1024, num_classes: int = 3):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes)
        self.bbox_pred = Linear(in_dim, num_classes * 4)

    def init_weights(self, gen: torch.Generator):
        normal_(self.cls_score.weight, 0.01, gen)
        normal_(self.bbox_pred.weight, 0.001, gen)
        nn.init.zeros_(self.cls_score.bias)
        nn.init.zeros_(self.bbox_pred.bias)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


@dataclasses.dataclass
class SampledRoIs:
    boxes: torch.Tensor  # f32 [B, S, 4]
    labels: torch.Tensor  # int64 [B, S] (0 background, > 0 foreground)
    reg_targets: torch.Tensor  # f32 [B, S, 4]
    is_pos: torch.Tensor  # bool [B, S]
    valid: torch.Tensor  # bool [B, S]
    matched_gt: torch.Tensor  # int64 [B, S] gt row (clamped at 0)


def subsample_proposals(r, proposals: Proposals, gt: GroundTruth, *, batch_size_per_image: int = 512,
                        positive_fraction: float = 0.25, fg_thresh: float = 0.5, bg_thresh: float = 0.5,
                        reg_weights=(10.0, 10.0, 5.0, 5.0)) -> SampledRoIs:
    """Match and balanced-sample the proposals of every image. r f32 [B, N]:
    the sampler's draws."""
    p_boxes = proposals.boxes
    matched = match(box_iou(gt.boxes, p_boxes), gt.valid, fg_thresh, bg_thresh)  # [B, N]
    m0 = matched.clamp(min=0)
    labels = torch.gather(gt.labels.long(), 1, m0)
    labels = torch.where(matched == -1, 0, labels)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    labels = torch.where(proposals.valid, labels, -1)  # padding is never sampled
    targets = encode(torch.gather(gt.boxes, 1, m0[..., None].expand(-1, -1, 4)), p_boxes, reg_weights)

    idx, is_pos, valid = sample(r, labels, batch_size_per_image, positive_fraction)
    idx4 = idx[..., None].expand(-1, -1, 4)
    return SampledRoIs(
        boxes=torch.gather(p_boxes, 1, idx4),
        labels=torch.where(is_pos, torch.gather(labels, 1, idx), 0),
        reg_targets=torch.gather(targets, 1, idx4),
        is_pos=is_pos,
        valid=valid,
        matched_gt=torch.gather(m0, 1, idx),
    )


def box_head_loss(class_logits, box_regression, rois: SampledRoIs):
    """(classification, box regression) losses. class_logits [B, S, C];
    box_regression [B, S, 4C]."""
    c = class_logits.shape[-1]
    logits = class_logits.reshape(-1, c).float()
    regs = box_regression.reshape(-1, 4 * c).float()
    labels = rois.labels.reshape(-1)
    valid = rois.valid.reshape(-1).float()
    # both losses count the sampled RoIs of the global batch
    count = comm.global_sum(valid.sum())
    cls_loss = L.softmax_ce(logits, labels, weight=valid, normalizer=count)
    offs = 4 * labels.clamp(min=0)[:, None] + torch.arange(4, device=labels.device)[None, :]
    box_loss = L.smooth_l1_sum(torch.gather(regs, 1, offs), rois.reg_targets.reshape(-1, 4), beta=1.0,
                               weight=rois.is_pos.reshape(-1).float()[:, None])
    return cls_loss, box_loss / count.clamp(min=1.0)


def postprocess_boxes(class_logits, box_regression, proposals: Proposals, image_sizes, *, num_classes: int,
                      score_thresh: float = 0.05, nms_thresh: float = 0.5, detections_per_img: int = 200,
                      reg_weights=(10.0, 10.0, 5.0, 5.0), nms_type: str = "greedy") -> Detections:
    """Detections of the box head without relation-NMS (box_head/inference.py:92-145).

    class_logits [B, N, C]; box_regression [B, N, 4C]; proposals [B, N];
    image_sizes int [B, 2]. Softmax, per-class decode and clip, score >
    ``score_thresh``; "greedy": the NMS survivors of each (image, class),
    the best ``detections_per_img`` of each, all B x (C-1) problems in one
    NMS launch; "set": the best of each class without NMS, each tagged with
    its proposal in ``head_ids`` for ``set_nms_filter``. Then the best
    ``detections_per_img`` of each image over its classes."""
    b, n = class_logits.shape[:2]
    k = num_classes - 1
    probs = torch.softmax(class_logits.float(), dim=-1)
    decoded = decode(box_regression.float(), proposals.boxes, reg_weights).reshape(b, n, num_classes, 4)
    decoded = clip_to_image(decoded, image_sizes[:, 0, None, None], image_sizes[:, 1, None, None])
    # one problem per (image, foreground class), image-major
    boxes = decoded[:, :, 1:].permute(0, 2, 1, 3).reshape(b * k, n, 4)
    scores = probs[..., 1:].permute(0, 2, 1).reshape(b * k, n)
    valid = (proposals.valid[:, None, :] & (probs[..., 1:].permute(0, 2, 1) > score_thresh)).reshape(b * k, n)
    if nms_type == "set":
        masked = torch.where(valid, scores, NEG_INF)
        top, idx = top_k(masked, min(detections_per_img, n))
        v = top > NEG_INF / 10
    else:
        idx, v = nms_topk(boxes, scores, valid, nms_thresh, detections_per_img)
    m = idx.shape[1]
    sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)).reshape(b, k * m, 4)
    sel_scores = torch.where(v, torch.gather(scores, 1, idx), 0.0).reshape(b, k * m)
    labels = torch.arange(1, num_classes, dtype=torch.int32, device=idx.device).repeat_interleave(m)
    v = v.reshape(b, k * m)
    top_scores, top_idx = top_k(torch.where(v, sel_scores, NEG_INF), detections_per_img)
    keep = top_scores > NEG_INF / 10
    labels = labels[top_idx]
    return Detections(
        boxes=torch.gather(sel_boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(keep, top_scores, 0.0),
        labels=torch.where(keep, labels, 0),
        valid=keep,
        head_ids=torch.gather(idx.reshape(b, k * m), 1, top_idx) if nms_type == "set" else None,
    )


def set_nms_filter(boxes, scores, labels, valid, head_ids, nms_thresh=0.5, num_classes=3):
    """The host pass of nms_type "set" on one image's numpy arrays: per
    class, set-NMS over its valid detections; returns ``valid`` with the
    suppressed ones cleared."""
    import numpy as np

    from ..ops.python_nms import set_cpu_nms

    valid = np.asarray(valid).copy()
    for j in range(1, num_classes):
        sel = np.flatnonzero(valid & (np.asarray(labels) == j))
        if len(sel) < 2:
            continue
        keep = set_cpu_nms(np.asarray(boxes)[sel], np.asarray(scores)[sel], np.asarray(head_ids)[sel], nms_thresh)
        valid[sel[~keep]] = False
    return valid
