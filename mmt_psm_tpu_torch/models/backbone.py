"""ResNet-FPN backbone (port of ``mmt_psm_tpu/models/backbone.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .fpn import FPN
from .resnet import ResNet


class ResNetFPNBackbone(nn.Module):
    def __init__(self, conv_body: str = "R-50-FPN", out_channels: int = 256, stride_in_1x1: bool = True,
                 freeze_at: int = 2):
        super().__init__()
        self.body = ResNet(conv_body=conv_body, stride_in_1x1=stride_in_1x1, freeze_at=freeze_at)
        self.fpn = FPN((256, 512, 1024, 2048), out_channels)

    def init_weights(self, gen: torch.Generator):
        self.body.init_weights(gen)
        self.fpn.init_weights(gen)

    def forward(self, images_nhwc: torch.Tensor):
        """images [B, H, W, 3] -> P2..P6 as NHWC [B, H_l, W_l, C] views of
        channels_last maps (contiguous, as the pooler wants them)."""
        x = images_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.fpn(self.body(x))
        return [f.permute(0, 2, 3, 1) for f in feats]
