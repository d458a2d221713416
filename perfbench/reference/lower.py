"""The control's precision: the reference with every convolution and linear
layer computed from float8 (e4m3) operands, the step below the bfloat16
that the configurations state.

Each weight (on every use, so a trained weight too) and each layer's input
on every call is rounded to float8 e4m3 with one scale per tensor (its
largest magnitude mapped to e4m3's largest finite value, 448); the products
then run in the layer's own dtype on the rounded values. Gradients pass
the rounding unchanged (straight through).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in its
    dtype; the gradient passes straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / E4M3_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


class _Round(nn.Module):
    def forward(self, w):
        return fp8_round(w)


def _round_input(module, args):
    return (fp8_round(args[0]), *args[1:])


def to_fp8(net: nn.Module) -> nn.Module:
    """Compute ``net``'s conv and linear layers from float8 operands. Returns ``net``."""
    for m in list(net.modules()):
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            parametrize.register_parametrization(m, "weight", _Round())
            m.register_forward_pre_hook(_round_input)
    return net
