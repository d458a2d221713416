"""ResNet body with frozen BN (port of ``mmt_psm_tpu/models/resnet.py``).

7x7/2 stem conv (a plain conv; the JAX package's space-to-depth rewrite
is a TPU layout trick with identical math) + FrozenBN + 3x3/2 max-pool,
then bottleneck stages with the stride on the first 1x1 conv
(STRIDE_IN_1X1). Module names are maskrcnn-benchmark's
(``layer1.0.conv1``, ``layer1.0.downsample.0``) so ``state_dict`` keys
match the reference checkpoint.

The stage specs are the JAX package's (``STAGE_SPECS``, resnet.py:28-33):
the FPN bodies return C2..C5, R-50-C4 stops after layer3 and returns C4,
R-50-C5 returns C5. With ``remat`` (TPU.REMAT_BACKBONE) each bottleneck
runs under ``torch.utils.checkpoint`` when gradients are on: its
activations are recomputed in the backward instead of kept, and the
gradients do not change (the JAX ``nn.remat``).

Where no gradient is recorded (``torch.is_grad_enabled()`` False: serving,
the teacher), every FrozenBN is applied in one epilogue pass over its
conv's output with the ReLU and the residual (``layers.conv_frozen_bn_relu``:
kernels K5 and K6); the downsample's FrozenBN joins the epilogue of
``conv3``, so its branch has no pass of its own. The constants are read
from the weights and buffers on every call, so nothing is kept to go
stale, and in float32 the result is the modules' own, bit for bit. With
gradients on, the modules run one after another as written.

FREEZE_CONV_BODY_AT as the JAX model does it: the stem's output and the
output of every stage below ``freeze_at`` are detached (its
``stop_gradient``, resnet.py:98-99, 119-120), and those modules' weights
do not require gradients (the reference's ``requires_grad_(False)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import Conv2d, FrozenBatchNorm2d, conv_frozen_bn, conv_frozen_bn_relu, variance_scaling_

# conv body -> (blocks per stage, which stages' outputs it returns)
STAGE_SPECS = {
    "R-50-C4": ((3, 4, 6), (False, False, True)),
    "R-50-C5": ((3, 4, 6, 3), (False, False, False, True)),
    "R-50-FPN": ((3, 4, 6, 3), (True, True, True, True)),
    "R-101-FPN": ((3, 4, 23, 3), (True, True, True, True)),
}


class Stem(nn.Module):
    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(out_channels)

    def forward(self, x):
        if torch.is_grad_enabled():
            x = F.relu(self.bn1(self.conv1(x)))
        else:
            x = conv_frozen_bn_relu(self.conv1, self.bn1, x)
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
        if torch.is_grad_enabled():
            residual = x if self.downsample is None else self.downsample(x)
            out = F.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            return F.relu(out + residual)
        out = conv_frozen_bn_relu(self.conv1, self.bn1, x)
        out = conv_frozen_bn_relu(self.conv2, self.bn2, out)
        if self.downsample is None:
            return conv_frozen_bn_relu(self.conv3, self.bn3, out, x)
        return conv_frozen_bn_relu(self.conv3, self.bn3, out, *conv_frozen_bn(*self.downsample, x))


class ResNet(nn.Module):
    """Returns the outputs of the stages the conv body's spec selects."""

    def __init__(self, conv_body: str = "R-50-FPN", stem_out_channels: int = 64,
                 res2_out_channels: int = 256, width_per_group: int = 64, stride_in_1x1: bool = True,
                 freeze_at: int = 2, remat: bool = False):
        super().__init__()
        self.freeze_at, self.remat = freeze_at, remat
        self.stem = Stem(stem_out_channels)
        in_ch = stem_out_channels
        self.stages = []
        blocks_per_stage, self.returns = STAGE_SPECS[conv_body]
        for i, n_blocks in enumerate(blocks_per_stage):
            bott, out = width_per_group * 2**i, res2_out_channels * 2**i
            blocks = []
            for b in range(n_blocks):
                stride = (1 if i == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(in_ch, bott, out, stride, stride_in_1x1))
                in_ch = out
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.stages.append(f"layer{i + 1}")
        self.out_channels = in_ch
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
                    variance_scaling_(m.weight, 1.0, "fan_in", "truncated_normal", gen)

    def forward(self, x):
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outs = []
        remat = self.remat and torch.is_grad_enabled()
        for i, name in enumerate(self.stages):
            for block in getattr(self, name):
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if self.freeze_at >= i + 2:
                x = x.detach()
            if self.returns[i]:
                outs.append(x)
        return outs
