"""The reference's serving forward: the device stage's normalisation of raw
uint8 canvases, a frozen copy of the program's
``engine/inference.py::DeviceStage.normalize``, then the detector.

``detect`` gives the reference's own detections; ``masks_on`` gives the
reference's mask probabilities on given detections (the served ones), the
way the served model's tokens are scored under the reference.
"""

from __future__ import annotations

import torch

from .models.mask_head import select_mask_probs

PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)


def normalize(images: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Raw RGB uint8 canvases [B, H, W, 3] -> BGR float32 minus the pixel
    mean, 0 outside each image's true (h, w)."""
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=images.device)
    x = images.flip(-1).float() - mean
    h, w = images.shape[1:3]
    ys = torch.arange(h, device=images.device)[None, :, None]
    xs = torch.arange(w, device=images.device)[None, None, :]
    inside = (ys < sizes[:, 0, None, None]) & (xs < sizes[:, 1, None, None])
    return torch.where(inside[..., None], x, torch.zeros((), device=images.device))


@torch.no_grad()
def detect(net, images: torch.Tensor, sizes: torch.Tensor):
    """The reference's detections of a batch of raw canvases, and its
    feature pyramid (for ``masks_on``)."""
    x = normalize(images, sizes)
    features = net.backbone_features(x)
    return net.detections_from_features(features, sizes, x), features


@torch.no_grad()
def masks_on(net, features, boxes: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mask probabilities [B, K, R, R] of the mask head and the mask relation
    module run on the given detections."""
    logits, feats = net.mask_forward(features, boxes)
    if net.config.with_relation_mask:
        logits = net.refine_masks(logits, feats, labels, valid)
    return select_mask_probs(logits, labels)
