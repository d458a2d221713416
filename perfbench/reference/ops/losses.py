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
    """Elementwise binary cross entropy on logits, in the JAX package's form,
    with its gradient at a logit of exactly 0 (-target): ``torch.maximum``
    splits the tie with 0 in halves as ``jnp.maximum`` does (``clamp``
    passes all of it), and |x| is taken as ``where(x >= 0, x, -x)``, whose
    slope at 0 is 1 as ``jnp.abs``'s is (``torch.abs``'s is 0). Such logits
    occur: a dead ReLU before a head whose bias is 0 leaves every logit it
    reaches at 0."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    magnitude = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, zero) - logits * targets + torch.log1p(torch.exp(-magnitude))


def softmax_ce(logits, labels, weight=None, normalizer=None):
    """Sparse-label cross entropy over the last axis."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _masked_mean(nll, weight, normalizer)
