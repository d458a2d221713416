"""Balanced positive/negative sampler on fixed shapes (port of
``mmt_psm_tpu/ops/sampler.py::sample``).

Up to ``batch_size * positive_fraction`` positives in a random order, then
random negatives to fill ``batch_size`` slots; ignored items (label -1) are
never taken, and slots past the candidates are invalid. The randomness is
the uniform draw ``r`` per item, an argument here: the caller makes it
with ``uniform`` from its generator. torch's generator cannot reproduce
``jax.random``, so the parity tests hand both packages the same ``r``.
"""

from __future__ import annotations

import torch

from ..parallel import comm


def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """The sampler's draws: U[0, 1) f32 of ``shape`` from ``gen``, its
    leading axis this rank's images. Under data parallelism the table of
    the global batch is drawn (every rank's generator alike) and the rank
    keeps its rows, so the draws are those of one process on the global batch.

    The train step's sampler draws come from here, so a test can replace it."""
    shape = tuple(shape)
    return comm.rank_rows(torch.rand((comm.global_rows(shape[0]), *shape[1:]), generator=gen, device=device))


def sample(r: torch.Tensor, labels: torch.Tensor, batch_size: int, positive_fraction: float):
    """r f32 [..., N] uniform draws; labels int [..., N] (>= 1 positive,
    0 negative, -1 ignore).

    Returns (idx int64 [..., batch_size], is_pos bool, valid bool): slot i
    holds the i-th sampled positive for i < num_pos, then negatives.
    """
    n = labels.shape[-1]
    is_pos = labels >= 1
    is_neg = labels == 0
    # random permutations with the candidates first (stable: ties by index)
    pos_order = torch.sort(torch.where(is_pos, r, 2.0), dim=-1, stable=True)[1]
    neg_order = torch.sort(torch.where(is_neg, r, 2.0), dim=-1, stable=True)[1]

    max_pos = int(batch_size * positive_fraction)
    num_pos = is_pos.sum(-1, keepdim=True).clamp(max=max_pos)
    num_neg = torch.minimum(is_neg.sum(-1, keepdim=True), batch_size - num_pos)

    slot = torch.arange(batch_size, device=labels.device)
    take_pos = slot < num_pos
    pos_slot = slot.clamp(max=n - 1).expand(*labels.shape[:-1], batch_size)
    neg_slot = (slot - num_pos).clamp(0, n - 1)
    idx = torch.where(take_pos, torch.gather(pos_order, -1, pos_slot), torch.gather(neg_order, -1, neg_slot))
    valid = slot < num_pos + num_neg
    return idx, take_pos & valid, valid
