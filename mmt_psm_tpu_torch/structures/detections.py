"""Padded fixed-size containers, 1:1 with ``mmt_psm_tpu/structures/detections.py``.

Every stage exchanges ``[B, N, ...]`` tensors with an explicit ``valid``
mask, so no shape depends on the data and the forward needs no host sync.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Proposals:
    boxes: torch.Tensor  # f32 [B, N, 4] xyxy
    scores: torch.Tensor  # f32 [B, N] objectness
    valid: torch.Tensor  # bool [B, N]


@dataclasses.dataclass
class GroundTruth:
    boxes: torch.Tensor  # f32 [B, M, 4]
    labels: torch.Tensor  # int [B, M] (1..C-1)
    valid: torch.Tensor  # bool [B, M]
    masks: torch.Tensor | None = None  # u8/f32 [B, M, Hm, Wm] full-image instance masks


@dataclasses.dataclass
class Detections:
    boxes: torch.Tensor  # f32 [B, K, 4]
    scores: torch.Tensor  # f32 [B, K]
    labels: torch.Tensor  # int32 [B, K]
    valid: torch.Tensor  # bool [B, K]
    masks: torch.Tensor | None = None  # f32 [B, K, R, R] mask probabilities
