"""Shared layers (port of ``mmt_psm_tpu/models/layers.py``).

Parameters stay float32; each layer computes in the dtype of its input,
casting its weights per call, as the JAX modules do with ``dtype=`` (bf16
activations in the flagship, f32 where the JAX model casts to f32).
Convolutions run NCHW in ``channels_last`` memory, so a map permuted to
NHWC for the pooler is already contiguous.

Where no gradient is recorded, the ResNet body applies each FrozenBN in
the epilogue of the conv before it (``conv_frozen_bn_relu``): kernel K5
(``prepare_conv_bn``) casts the conv's weight and computes FrozenBN's scale
and shift in one launch, and kernel K6 (``bn_residual_relu``) applies them,
the residual and the ReLU over the conv's output in one pass
(``csrc/frozen_bn.cu``), with the unfused formula's roundings. CPU tensors
take the plain versions of both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x, weight=None):
        """``weight``: this conv's weight already in x's dtype (from K5,
        ``conv_frozen_bn``); by default it is cast here."""
        w = self.weight.to(x.dtype) if weight is None else weight
        return F.conv2d(x, w, _cast(self.bias, x.dtype), self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def _apply(x, ss):
    """x * scale + shift over x's channels, both cast to x's dtype (ss: scale, shift)."""
    return x * ss[0].to(x.dtype)[:, None, None] + ss[1].to(x.dtype)[:, None, None]


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

    def scale_shift(self):
        """(scale, shift) in float32, from the buffers as they are now."""
        scale = self.weight * torch.reciprocal(torch.sqrt(self.running_var))
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        return _apply(x, self.scale_shift())


_EPILOGUE_DTYPES = (torch.float32, torch.bfloat16)


def conv_frozen_bn(conv, bn, x):
    """(conv(x), bn's float32 scale and shift [2, O]): the conv on its weight
    in x's dtype, and the constants of bn for an epilogue, both from one
    launch of K5 (``prepare_conv_bn``). bn is not applied."""
    w, ss = prepare_conv_bn(conv.weight, bn, x.dtype)
    y = conv(x, w)
    # K6 reads NHWC: cuDNN writes channels_last for a channels_last input,
    # PyTorch's own CUDA conv (cuDNN disabled) may not
    return (y.contiguous(memory_format=torch.channels_last) if y.is_cuda else y), ss


def conv_frozen_bn_relu(conv, bn, x, residual=None, residual_ss=None):
    """relu(bn(conv(x)) + residual) in three launches: K5, the conv, K6 in
    place over its output. ``residual_ss``: the scale and shift that
    ``residual`` still lacks (a downsample's, from ``conv_frozen_bn``). For
    forwards that record no gradient: nothing here has a backward. Equal to
    the modules' own formula bit for bit."""
    y, ss = conv_frozen_bn(conv, bn, x)
    return bn_residual_relu(y, ss, residual, residual_ss)


def prepare_conv_bn(weight, bn, dtype):
    """(weight.to(dtype), [scale, shift] f32 [2, O] of bn): kernel K5 on CUDA
    tensors, the plain version on CPU tensors."""
    if weight.is_cuda:
        return prepare_conv_bn_cuda(weight, bn, dtype)
    if weight.device.type == "cpu":
        return prepare_conv_bn_plain(weight, bn, dtype)
    raise ValueError(f"prepare_conv_bn: unsupported device {weight.device}")


def prepare_conv_bn_plain(weight, bn, dtype):
    """Plain PyTorch version of kernel K5: ``FrozenBatchNorm2d``'s own float32
    formula, and the conv's weight cast as ``Conv2d`` casts it."""
    return weight.to(dtype), torch.stack(bn.scale_shift())


def prepare_conv_bn_cuda(weight, bn, dtype):
    """Kernel K5 (``csrc/frozen_bn.cu``): weight f32 [O, ...] contiguous, bn's
    buffers f32 [O], all on one card; ``dtype`` float32 (the conv takes
    ``weight`` itself) or bf16 (one launch also writes the cast weight)."""
    stats = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    dev = kernels.require_cuda("prepare_conv_bn", weight, *stats)
    o = weight.shape[0]
    for t in (weight, *stats):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"prepare_conv_bn: every tensor must be contiguous float32, got {t.dtype}")
    if any(t.shape != (o,) for t in stats):
        raise ValueError(f"prepare_conv_bn: FrozenBN buffers must be [{o}], got {[tuple(t.shape) for t in stats]}")
    if dtype not in _EPILOGUE_DTYPES:
        raise ValueError(f"prepare_conv_bn: dtype must be float32 or bfloat16, got {dtype}")
    w = weight if dtype == torch.float32 else torch.empty(weight.shape, dtype=dtype, device=dev)
    ss = torch.empty((2, o), dtype=torch.float32, device=dev)
    lib = kernels.library("frozen_bn")
    with torch.cuda.device(dev):
        err = lib.prepare_conv_bn(weight.data_ptr(), *[t.data_ptr() for t in stats],
                                  None if w is weight else w.data_ptr(), ss.data_ptr(), o, weight.numel(),
                                  kernels.stream_handle(dev))
    kernels.check(err, "prepare_conv_bn")
    prepare_conv_bn_cuda.launches += 1
    return w, ss


prepare_conv_bn_cuda.launches = 0


def bn_residual_relu(y, ss, residual=None, residual_ss=None):
    """relu(y * scale + shift (+ residual, itself times its scale plus its
    shift where ``residual_ss`` is given)): ``FrozenBatchNorm2d`` and the
    bottleneck's formula, every operation rounded to y's dtype as there.
    ss, residual_ss: f32 [2, C], scale then shift. y is consumed (K6 writes
    over it). Kernel K6 on CUDA tensors, the plain version on CPU tensors."""
    if y.is_cuda:
        return bn_residual_relu_cuda(y, ss, residual, residual_ss)
    if y.device.type == "cpu":
        return bn_residual_relu_plain(y, ss, residual, residual_ss)
    raise ValueError(f"bn_residual_relu: unsupported device {y.device}")


def bn_residual_relu_plain(y, ss, residual=None, residual_ss=None):
    """Plain PyTorch version of kernel K6, y [N, C, H, W]: the unfused
    formula, one operator a pass."""
    y = _apply(y, ss)
    if residual is not None:
        y = y + (residual if residual_ss is None else _apply(residual, residual_ss))
    return torch.relu(y)


def bn_residual_relu_cuda(y, ss, residual=None, residual_ss=None):
    """Kernel K6 (``csrc/frozen_bn.cu``), in place over y: y and the
    residual [N, C, H, W] channels_last in float32 or bf16, C a multiple of
    8, ss and residual_ss contiguous f32 [2, C], every base 16-byte aligned,
    all on one card."""
    ts = tuple(t for t in (y, ss, residual, residual_ss) if t is not None)
    dev = kernels.require_cuda("bn_residual_relu", *ts)
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bn_residual_relu: y must be [N, C, H, W] channels_last, got {tuple(y.shape)}")
    n, c, h, w = y.shape
    if c % 8 or y.dtype not in _EPILOGUE_DTYPES:
        raise ValueError(f"bn_residual_relu: need C a multiple of 8 in float32 or bf16, got {c} {y.dtype}")
    for t in (ss, residual_ss):
        if t is not None and (t.dtype != torch.float32 or t.shape != (2, c) or not t.is_contiguous()):
            raise ValueError(f"bn_residual_relu: scale and shift must be contiguous float32 [2, {c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if residual is not None and (residual.shape != y.shape or residual.dtype != y.dtype
                                 or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"bn_residual_relu: residual must be {tuple(y.shape)} {y.dtype} channels_last, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("bn_residual_relu: every base must be 16-byte aligned")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = kernels.library("frozen_bn")
    with torch.cuda.device(dev):
        err = lib.bn_residual_relu(y.data_ptr(), ss.data_ptr(), ptr(residual), ptr(residual_ss), n * h * w, c,
                                   int(y.dtype == torch.bfloat16), kernels.stream_handle(dev))
    kernels.check(err, "bn_residual_relu")
    bn_residual_relu_cuda.launches += 1
    return y


bn_residual_relu_cuda.launches = 0


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
