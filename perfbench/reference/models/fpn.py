"""Feature Pyramid Network (port of ``mmt_psm_tpu/models/fpn.py``).

1x1 lateral convs, nearest 2x top-down, 3x3 output convs, and P6 as the
reference's LastLevelMaxPool (max_pool kernel 1, stride 2), i.e. ``::2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, variance_scaling_


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"fpn_inner{i + 1}", Conv2d(c, out_channels, 1))
            setattr(self, f"fpn_layer{i + 1}", Conv2d(out_channels, out_channels, 3, padding=1))

    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, Conv2d):
                variance_scaling_(m.weight, 1.0 / 3, "fan_in", "uniform", gen)
                nn.init.zeros_(m.bias)

    def forward(self, features):
        inner = lambda i: getattr(self, f"fpn_inner{i + 1}")  # noqa: E731
        layer = lambda i: getattr(self, f"fpn_layer{i + 1}")  # noqa: E731
        last_inner = inner(self.n - 1)(features[-1])
        results = [layer(self.n - 1)(last_inner)]
        for i in range(self.n - 2, -1, -1):
            top_down = F.interpolate(last_inner, scale_factor=2, mode="nearest")
            last_inner = inner(i)(features[i]) + top_down
            results.insert(0, layer(i)(last_inner))
        results.append(results[-1][:, :, ::2, ::2])
        return results
