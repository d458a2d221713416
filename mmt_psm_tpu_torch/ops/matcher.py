"""IoU argmax matcher on padded, batched tensors (port of
``mmt_psm_tpu/ops/matcher.py::match``).

Each prediction gets its best ground truth by quality (the first index
among equals, as ``argmax`` gives it on both frameworks), stratified into
matched (>= high), BETWEEN_THRESHOLDS (-2, in [low, high)) and
BELOW_LOW_THRESHOLD (-1, < low). With ``allow_low_quality_matches`` every
valid gt restores its argmax match on every prediction tied at its best
quality. Padded gt rows count as quality -1e9 and never match.
"""

from __future__ import annotations

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2

_NEG = -1e9


def match(quality: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float, low_threshold: float,
          allow_low_quality_matches: bool = False) -> torch.Tensor:
    """quality f32 [..., M, N] (M gt, N predictions); gt_valid bool [..., M].

    Returns int64 [..., N]: a gt index in [0, M), -1 or -2.
    """
    q = torch.where(gt_valid[..., :, None], quality, _NEG)
    matched_vals = q.amax(dim=-2)
    all_matches = q.argmax(dim=-2)  # first index among equals
    below = matched_vals < low_threshold
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    matches = torch.where(below, BELOW_LOW_THRESHOLD, all_matches)
    matches = torch.where(between, BETWEEN_THRESHOLDS, matches)
    if allow_low_quality_matches:
        highest = q.amax(dim=-1, keepdim=True)  # [..., M, 1]
        is_best = (q == highest) & gt_valid[..., :, None] & (highest > _NEG / 2)
        matches = torch.where(is_best.any(dim=-2), all_matches, matches)
    return matches
