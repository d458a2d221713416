"""SGD with the reference's parameter groups, warmup-multistep learning
rate and global-norm clipping (port of ``mmt_psm_tpu/train/optim.py:67-117``).

* ``torch.optim.SGD``, momentum 0.9: v <- mu*v + (g + wd*p), p <- p - lr*v,
  which is the JAX package's optax chain step for step;
* biases get lr x BIAS_LR_FACTOR and WEIGHT_DECAY_BIAS;
* linear warmup from WARMUP_FACTOR over WARMUP_ITERS, then x GAMMA at each
  of STEPS (a ``LambdaLR``);
* frozen tensors get no update: the stem and the stages below
  FREEZE_CONV_BODY_AT do not require gradients, and the FrozenBN tensors
  are buffers, outside the optimizer;
* SOLVER.CLIP_GRAD_NORM > 0 scales the gradients by max_norm / norm where
  the global norm reaches max_norm. The norm counts the tensors the JAX
  package's norm counts: optax clips before it masks the frozen tensors,
  and in the JAX model the FrozenBN weight, bias, mean and variance are
  parameters, so the gradients of those in the trainable stages are part
  of its global norm. ``clip_tensors`` has autograd compute them here too.
"""

from __future__ import annotations

import torch

from ..models.layers import FrozenBatchNorm2d
from ..models.resnet import ResNet


def warmup_multistep_factor(step: int, steps, gamma: float = 0.1, warmup_factor: float = 1.0 / 3,
                            warmup_iters: int = 500, warmup_method: str = "linear") -> float:
    """The factor on the base learning rate at ``step`` (0-based)."""
    if step < warmup_iters:
        if warmup_method == "constant":
            wf = warmup_factor
        else:
            alpha = step / max(warmup_iters, 1)
            wf = warmup_factor * (1 - alpha) + alpha
    else:
        wf = 1.0
    return wf * gamma ** sum(step >= s for s in steps)


def schedule_factor(cfg):
    """The SOLVER block's factor on the base learning rate, a function of
    the step."""
    s = cfg.SOLVER
    steps = tuple(int(x) for x in s.STEPS)
    return lambda i: warmup_multistep_factor(i, steps, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS, s.WARMUP_METHOD)


def make_optimizer(model: torch.nn.Module, cfg):
    """(SGD over the trainable parameters in a weight group and a bias
    group, its LambdaLR schedule) from the SOLVER block."""
    s = cfg.SOLVER
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups = [
        {"params": [p for n, p in trainable if not n.endswith(".bias")], "lr": s.BASE_LR,
         "weight_decay": s.WEIGHT_DECAY},
        {"params": [p for n, p in trainable if n.endswith(".bias")], "lr": s.BASE_LR * s.BIAS_LR_FACTOR,
         "weight_decay": s.WEIGHT_DECAY_BIAS},
    ]
    opt = torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule_factor(cfg))


def clip_tensors(model: torch.nn.Module) -> list:
    """The tensors whose gradients the global norm counts: the trainable
    parameters and the FrozenBN tensors of the modules that are not frozen,
    which are made to require gradients (they stay out of the optimizer)."""
    frozen = set()
    for body in (m for m in model.modules() if isinstance(m, ResNet)):
        for name in body.frozen_modules():
            frozen.update(id(m) for m in getattr(body, name).modules())
    tensors = [p for p in model.parameters() if p.requires_grad]
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm2d) and id(m) not in frozen:
            for t in m.buffers(recurse=False):
                t.requires_grad_(True)
                tensors.append(t)
    return tensors


def clip_grad_norm_(tensors, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the norm of all the
    gradients reaches ``max_norm`` they are scaled by max_norm / norm.
    The norm is accumulated in float64: PyTorch's float32 norm of a tensor of
    ten million elements loses digits on the CPU, which would move every
    clipped step. Returns the norm; no host sync."""
    grads = [t.grad for t in tensors if t.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor.to(grads[0].dtype))
    return norm
