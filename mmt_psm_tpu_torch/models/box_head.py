"""RoI box head (port of ``mmt_psm_tpu/models/box_head.py:40-121, 177-198``).

FPN2MLPFeatureExtractor (fc6/fc7 over 7x7 pooled features, dropout after
each in training) and FPNPredictor (class logits, per-class box deltas);
in training, ``subsample_proposals`` matches proposals to gt (0.5/0.5)
and samples 512 per image at a quarter positives, and ``box_head_loss``
takes the cross entropy and the class-sliced smooth-L1 (beta 1) over the
sampled count. ``fc6.weight`` keeps the reference's layout, whose input
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
from ..ops.box_coder import encode
from ..ops.matcher import BETWEEN_THRESHOLDS, match
from ..ops.sampler import sample
from ..structures.boxes import box_iou
from ..structures.detections import GroundTruth, Proposals
from .layers import Linear, normal_, variance_scaling_


def dropout(x, p: float, gen: torch.Generator):
    """flax's ``Dropout``: keep with probability 1-p, scale kept values by
    1/(1-p), the mask drawn from ``gen``."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
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

    def forward(self, pooled, gen: torch.Generator | None = None):
        """pooled [N, P, P, C] -> [N, mlp_dim]. In training mode with a
        dropout rate, ``gen`` draws the dropout masks."""
        c, p = self.in_channels, self.resolution
        drop = self.training and self.dropout > 0
        if drop and gen is None:
            raise ValueError("train-mode dropout needs a generator")
        w6 = self.fc6.weight.reshape(-1, c, p, p).permute(0, 2, 3, 1).reshape(-1, p * p * c)
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(F.linear(x, w6.to(x.dtype), self.fc6.bias.to(x.dtype)))
        if drop:
            x = dropout(x, self.dropout, gen)
        x = F.relu(self.fc7(x))
        return dropout(x, self.dropout, gen) if drop else x


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


class BoxHead(nn.Module):
    """Holds extractor and predictor under ``roi_heads.box``."""

    def __init__(self, in_channels: int, resolution: int, mlp_dim: int, num_classes: int, dropout: float = 0.0):
        super().__init__()
        self.feature_extractor = FPN2MLPExtractor(in_channels, resolution, mlp_dim, dropout)
        self.predictor = FPNPredictor(mlp_dim, num_classes)


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
    cls_loss = L.softmax_ce(logits, labels, weight=valid)
    offs = 4 * labels.clamp(min=0)[:, None] + torch.arange(4, device=labels.device)[None, :]
    box_loss = L.smooth_l1_sum(torch.gather(regs, 1, offs), rois.reg_targets.reshape(-1, 4), beta=1.0,
                               weight=rois.is_pos.reshape(-1).float()[:, None])
    return cls_loss, box_loss / valid.sum().clamp(min=1.0)
