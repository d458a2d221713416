"""The losses of the supervised train step (port of the parts of
``mmt_psm_tpu/ops/losses.py`` the flagship uses), mask-aware: a weight
of 0 takes a padded row out exactly."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(loss, weight=None, normalizer=None):
    if weight is None:
        return loss.mean()
    loss = loss * weight
    denom = weight.sum() if normalizer is None else normalizer
    return loss.sum() / torch.clamp(denom, min=1.0)


def smooth_l1_sum(input, target, beta: float = 1.0 / 9, weight=None):
    """Huber loss in the reference's beta form, summed."""
    n = torch.abs(input - target)
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weight is not None:
        loss = loss * weight
    return loss.sum()


def bce_with_logits(logits, targets):
    """Elementwise binary cross entropy on logits, in the JAX package's form."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def softmax_ce(logits, labels, weight=None, normalizer=None):
    """Sparse-label cross entropy over the last axis."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _masked_mean(nll, weight, normalizer)
