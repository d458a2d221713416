"""Gradient manipulation (the port's copy of ``mmt_psm_tpu/ops/grad_ops.py``,
after the reference's GradientReversal layer, maskrcnn_benchmark/modeling/
utils.py:19-47, used by the MT.ADV adversarial branch, which the pap
configs leave off).
"""

from __future__ import annotations

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def gradient_reversal(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Identity forward; the backward multiplies the gradient by -scale."""
    return _GradientReversal.apply(x, scale)
