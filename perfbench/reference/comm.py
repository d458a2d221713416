"""One process: the reference runs on one device, so every collective of
the program's data-parallel helpers is the identity here."""

from __future__ import annotations

import torch

from .ops.topk import top_k


def global_sum(t: torch.Tensor) -> torch.Tensor:
    return t


def global_rows(n: int) -> int:
    return n


def rank_rows(t: torch.Tensor, groups: int = 1) -> torch.Tensor:
    return t


def global_kth(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of 1-D ``values`` as a 0-d tensor."""
    return top_k(values, k)[0][-1]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    return t
