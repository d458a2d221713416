"""Shared layers (port of ``mmt_psm_tpu/models/layers.py``).

Parameters stay float32; each layer computes in the dtype of its input,
casting its weights per call, as the JAX modules do with ``dtype=`` (bf16
activations in the flagship, f32 where the JAX model casts to f32).
Convolutions run NCHW in ``channels_last`` memory, so a map permuted to
NHWC for the pooler is already contiguous.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics: scale = weight * rsqrt(var) with
    NO eps, shift = bias - mean * scale (maskrcnn_benchmark
    layers/batch_norm.py). The four tensors are buffers, as in the
    reference, so they appear in ``state_dict`` under its names."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        scale = self.weight * torch.reciprocal(torch.sqrt(self.running_var))
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def variance_scaling_(w: torch.Tensor, scale: float, mode: str, distribution: str, gen: torch.Generator):
    """Seeded init with flax's ``variance_scaling``: "uniform", "normal" or
    "truncated_normal" (flax's default conv and dense init, ``lecun_normal``,
    is the last at scale 1 fan_in: a normal cut at 2 standard deviations and
    rescaled to the variance). ``w`` is a torch weight [out, in, *k] (or
    [in, out, *k] for a transposed conv, where the two fans swap roles
    as in flax)."""
    receptive = w[0, 0].numel() if w.dim() > 2 else 1
    fan = (w.shape[1] if mode == "fan_in" else w.shape[0]) * receptive
    var = scale / fan
    with torch.no_grad():
        if distribution == "uniform":
            limit = (3.0 * var) ** 0.5
            return w.uniform_(-limit, limit, generator=gen)
        if distribution == "truncated_normal":
            # the std of a unit normal cut to [-2, 2] (jax.nn.initializers)
            std = var ** 0.5 / 0.87962566103423978
            return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        return w.normal_(0.0, var ** 0.5, generator=gen)


def normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return w.normal_(0.0, std, generator=gen)
