"""``lax.top_k`` with its tie order.

``jax.lax.top_k`` returns equal values lowest index first, and ties are
common on this path (the -1e30 padding rows, scores zeroed by a
threshold, the index-0 padding slots of ``nms_topk``). ``torch.topk``
leaves the order of ties unspecified on CUDA, so the port takes the first
``k`` entries of a stable descending sort instead.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """Top ``k`` along the last dim: (values, int64 indices), ties by index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
