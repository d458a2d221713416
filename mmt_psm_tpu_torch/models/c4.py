"""The R-50-C4 RoI heads (port of ``mmt_psm_tpu/models/c4.py``).

maskrcnn-benchmark's C4 family (its default config): pooled C4 features
(14 x 14, one stride-16 level) go through the ResNet stage-5 head, three
bottlenecks from 1024 to 2048 channels with stride 2 in the first
(ResNet50Conv5ROIFeatureExtractor, roi_box_feature_extractors.py:12-42),
then FastRCNNPredictor averages the 7 x 7 map and applies ``cls_score`` and
``bbox_pred`` (roi_box_predictors.py:5-29). The C4 mask head shares the
stage-5 head and has only its own predictor.

The head computes in the model's compute dtype (``TPU.COMPUTE_DTYPE``,
bf16 by default), as every other layer of the port does.
The JAX modules take no ``dtype=``, so flax promotes the bf16 pooled
features to the float32 parameters and the JAX head runs in float32; that
is flax's dtype promotion, not a precision the configuration states. At
float32 the two compute the same.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from .layers import Linear, normal_, variance_scaling_
from .resnet import Bottleneck


class ResNetStage5Head(nn.Module):
    """``layer4``: ``blocks`` bottlenecks, ``in_channels`` -> 2048, the first
    with stride ``first_stride`` (14 x 14 -> 7 x 7)."""

    def __init__(self, in_channels: int = 1024, blocks: int = 3, bottleneck_channels: int = 512,
                 out_channels: int = 2048, first_stride: int = 2, stride_in_1x1: bool = True):
        super().__init__()
        layers = []
        for b in range(blocks):
            layers.append(Bottleneck(in_channels if b == 0 else out_channels, bottleneck_channels, out_channels,
                                     first_stride if b == 0 else 1, stride_in_1x1))
        self.layer4 = nn.Sequential(*layers)

    def forward(self, x):
        return self.layer4(x)


class ResNet50Conv5ROIExtractor(nn.Module):
    """Pooled features [N, P, P, C] (NHWC) -> stage-5 maps [N, 2048, P/2,
    P/2] in ``dtype``, NCHW in channels_last memory."""

    def __init__(self, in_channels: int = 1024):
        super().__init__()
        self.head = ResNetStage5Head(in_channels)

    def init_weights(self, gen: torch.Generator):
        # flax's default conv init (lecun normal), as the backbone's body
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                variance_scaling_(m.weight, 1.0, "fan_in", "truncated_normal", gen)

    def forward(self, pooled, dtype: torch.dtype):
        """``dtype``: the model's compute dtype. NHWC pooled features permute
        to channels_last NCHW without a copy; they are cast only where their
        dtype differs. Span ``roi_stage5``: once under the box head and once
        under the mask head a forward."""
        with record_function("roi_stage5"):
            x = pooled.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            return self.head(x)


class FastRCNNPredictor(nn.Module):
    """Spatial mean, then class logits and per-class box deltas."""

    def __init__(self, in_channels: int = 2048, num_classes: int = 3):
        super().__init__()
        self.cls_score = Linear(in_channels, num_classes)
        self.bbox_pred = Linear(in_channels, num_classes * 4)

    def init_weights(self, gen: torch.Generator):
        normal_(self.cls_score.weight, 0.01, gen)
        normal_(self.bbox_pred.weight, 0.001, gen)
        nn.init.zeros_(self.cls_score.bias)
        nn.init.zeros_(self.bbox_pred.bias)

    def forward(self, x):
        """x [N, C, H, W] -> (logits [N, classes], deltas [N, 4 classes])."""
        pooled = x.mean(dim=(2, 3))
        return self.cls_score(pooled), self.bbox_pred(pooled)
