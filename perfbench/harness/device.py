"""Device calls that the CPU rehearsal of a run skips."""

from __future__ import annotations

import torch


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def empty_cache(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
