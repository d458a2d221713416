"""RoI box head at test time (port of ``mmt_psm_tpu/models/box_head.py``).

FPN2MLPFeatureExtractor (fc6/fc7 over 7x7 pooled features) and
FPNPredictor (class logits, per-class box deltas). ``fc6.weight`` keeps
the reference's layout, whose input index runs over (C, H, W); the port
flattens pooled features in the JAX order (H, W, C), so the forward
permutes the weight's input axis, which it casts anyway, instead of
copying the activations. The JAX ``pool_boxes_batched`` is
``ops.pooler.multilevel_roi_align`` here, which takes the batch itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, normal_, variance_scaling_


class FPN2MLPExtractor(nn.Module):
    def __init__(self, in_channels: int = 256, resolution: int = 7, mlp_dim: int = 1024):
        super().__init__()
        self.in_channels, self.resolution = in_channels, resolution
        self.fc6 = Linear(in_channels * resolution**2, mlp_dim)
        self.fc7 = Linear(mlp_dim, mlp_dim)

    def init_weights(self, gen: torch.Generator):
        for m in (self.fc6, self.fc7):
            variance_scaling_(m.weight, 1.0 / 3, "fan_in", "uniform", gen)
            nn.init.zeros_(m.bias)

    def forward(self, pooled):
        """pooled [N, P, P, C] -> [N, mlp_dim]; inference mode (no dropout)."""
        c, p = self.in_channels, self.resolution
        w6 = self.fc6.weight.reshape(-1, c, p, p).permute(0, 2, 3, 1).reshape(-1, p * p * c)
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(F.linear(x, w6.to(x.dtype), self.fc6.bias.to(x.dtype)))
        return F.relu(self.fc7(x))


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

    def __init__(self, in_channels: int, resolution: int, mlp_dim: int, num_classes: int):
        super().__init__()
        self.feature_extractor = FPN2MLPExtractor(in_channels, resolution, mlp_dim)
        self.predictor = FPNPredictor(mlp_dim, num_classes)

