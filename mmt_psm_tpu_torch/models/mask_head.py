"""RoI mask head at test time (port of ``mmt_psm_tpu/models/mask_head.py``).

MaskRCNNFPNFeatureExtractor (14x14 pooled -> 4x conv256) and
MaskRCNNC4Predictor (2x2/2 deconv + 1x1 logits). Activations run NCHW in
channels_last memory; the head's inputs and outputs keep the JAX layouts
([N, P, P, C] features, [B, K, R, R, classes] logits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d, variance_scaling_


def kaiming_init(module: nn.Module, gen: torch.Generator):
    """flax variance_scaling(2.0, "fan_out", "normal") on every conv, bias 0."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            variance_scaling_(m.weight, 2.0, "fan_out", "normal", gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, ConvTranspose2d):
            # torch keeps [in, out, kh, kw]: flax's fan_out is shape[1] * k
            variance_scaling_(m.weight, 2.0, "fan_in", "normal", gen)
            nn.init.zeros_(m.bias)


class MaskRCNNFPNExtractor(nn.Module):
    def __init__(self, in_channels: int = 256, layers=(256, 256, 256, 256)):
        super().__init__()
        self.n = len(layers)
        for i, ch in enumerate(layers):
            setattr(self, f"mask_fcn{i + 1}", Conv2d(in_channels, ch, 3, padding=1))
            in_channels = ch

    def forward(self, x):
        """x NCHW (channels_last) -> NCHW."""
        for i in range(self.n):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return x


class MaskRCNNC4Predictor(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 3, dim_reduced: int = 256):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1)

    def forward(self, x):
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


def select_mask_probs(mask_logits, labels):
    """Per-detection sigmoid of its label's channel: [B, K, R, R, C] -> [B, K, R, R]."""
    lab = labels.clamp(min=0).long()
    idx = lab[:, :, None, None, None].expand(*mask_logits.shape[:4], 1)
    return torch.sigmoid(torch.gather(mask_logits.float(), -1, idx)[..., 0])
