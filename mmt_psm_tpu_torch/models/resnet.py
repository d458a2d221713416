"""ResNet body with frozen BN (port of ``mmt_psm_tpu/models/resnet.py``).

7x7/2 stem conv (a plain conv; the JAX package's space-to-depth rewrite
is a TPU layout trick with identical math) + FrozenBN + 3x3/2 max-pool,
then bottleneck stages with the stride on the first 1x1 conv
(STRIDE_IN_1X1). Module names are maskrcnn-benchmark's
(``layer1.0.conv1``, ``layer1.0.downsample.0``) so ``state_dict`` keys
match the reference checkpoint.

FREEZE_CONV_BODY_AT as the JAX model does it: the stem's output and the
output of every stage below ``freeze_at`` are detached (its
``stop_gradient``, resnet.py:98-99, 119-120), and those modules' weights
do not require gradients (the reference's ``requires_grad_(False)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, FrozenBatchNorm2d, variance_scaling_

STAGE_BLOCKS = {"R-50-FPN": (3, 4, 6, 3), "R-101-FPN": (3, 4, 23, 3)}


class Stem(nn.Module):
    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(out_channels)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class Bottleneck(nn.Module):
    def __init__(self, in_channels, bottleneck_channels, out_channels, stride=1, stride_in_1x1=True):
        super().__init__()
        self.downsample = None
        if in_channels != out_channels:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(out_channels),
            )
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=s1, bias=False)
        self.bn1 = FrozenBatchNorm2d(bottleneck_channels)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, stride=s3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(bottleneck_channels)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_channels)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Returns the outputs of the four stages (C2..C5)."""

    def __init__(self, conv_body: str = "R-50-FPN", stem_out_channels: int = 64,
                 res2_out_channels: int = 256, width_per_group: int = 64, stride_in_1x1: bool = True,
                 freeze_at: int = 2):
        super().__init__()
        self.freeze_at = freeze_at
        self.stem = Stem(stem_out_channels)
        in_ch = stem_out_channels
        self.stages = []
        for i, n_blocks in enumerate(STAGE_BLOCKS[conv_body]):
            bott, out = width_per_group * 2**i, res2_out_channels * 2**i
            blocks = []
            for b in range(n_blocks):
                stride = (1 if i == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(in_ch, bott, out, stride, stride_in_1x1))
                in_ch = out
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.stages.append(f"layer{i + 1}")
        for name in self.frozen_modules():
            getattr(self, name).requires_grad_(False)

    def frozen_modules(self):
        """Names of the stem and the stages below ``freeze_at``."""
        return (["stem"] if self.freeze_at >= 1 else []) + self.stages[: max(self.freeze_at - 1, 0)]

    def init_weights(self, gen: torch.Generator):
        # flax defaults: lecun normal for the body convs, kaiming fan_out for the stem
        for name, m in self.named_modules():
            if isinstance(m, Conv2d):
                if name == "stem.conv1":
                    variance_scaling_(m.weight, 2.0, "fan_out", "normal", gen)
                else:
                    variance_scaling_(m.weight, 1.0, "fan_in", "normal", gen)

    def forward(self, x):
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outs = []
        for i, name in enumerate(self.stages):
            x = getattr(self, name)(x)
            if self.freeze_at >= i + 2:
                x = x.detach()
            outs.append(x)
        return outs
