"""Teacher EMA update (port of ``mmt_psm_tpu/train/ema.py:16-20``).

The reference mean teacher's rule (maskrcnn_benchmark/engine/MTtrainer.py:
277-281): ``alpha = min(1 - 1/(iter + 1), alpha_max)``, then
``teacher = alpha * teacher + (1 - alpha) * student``, in place.
"""

from __future__ import annotations

import numpy as np
import torch


def ema_alpha(iteration: int, alpha_max: float) -> np.float32:
    """The EMA weight in float32, as the JAX package computes it."""
    one = np.float32(1.0)
    return min(one - one / (np.float32(iteration) + one), np.float32(alpha_max))


@torch.no_grad()
def ema_update_(teacher_tensors, student_tensors, iteration: int, alpha_max: float) -> None:
    """teacher <- alpha * teacher + (1 - alpha) * student over two lists of
    float32 tensors; the weights are host numbers, so nothing waits on the card."""
    alpha = ema_alpha(iteration, alpha_max)
    torch._foreach_mul_(teacher_tensors, float(alpha))
    torch._foreach_add_(teacher_tensors, torch._foreach_mul(student_tensors, float(np.float32(1.0) - alpha)))
