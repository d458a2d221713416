"""Consistency-weight ramp schedules (port of ``mmt_psm_tpu/utils/ramp.py:14-39``).

The same curves as the reference (maskrcnn_benchmark/utils/miscellaneous.py:
233-262). The iteration is a host number in the port's trainer, so the
ramps are numpy float32 arithmetic, in the JAX package's operation order:
the weight never has to be read back from the card.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def sigmoid_rampup(current, rampup_length):
    """exp(-5 (1 - t)^2), t = current / length clipped to [0, 1]."""
    if rampup_length == 0:
        return F32(1.0)
    t = np.clip(F32(current) / F32(rampup_length), F32(0.0), F32(1.0))
    phase = F32(1.0) - t
    return np.exp(F32(-5.0) * phase * phase)


def sigmoid_rampdown(gap_time, rampdown_length):
    """exp(-12 (1 - g/L)^2). The reference does not clip the phase
    (miscellaneous.py:242-247), and neither does this."""
    if rampdown_length == 0:
        return F32(1.0)
    phase = F32(1.0) - F32(gap_time) / F32(rampdown_length)
    return np.exp(F32(-12.0) * phase * phase)


def linear_rampup(current, rampup_length):
    if rampup_length == 0:
        return F32(1.0)
    return np.clip(F32(current) / F32(rampup_length), F32(0.0), F32(1.0))


def cosine_rampdown(current, rampdown_length):
    return F32(0.5) * (np.cos(F32(np.pi) * F32(current) / F32(rampdown_length)) + F32(1.0))
