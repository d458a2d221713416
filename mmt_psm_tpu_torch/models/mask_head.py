"""RoI mask head (port of ``mmt_psm_tpu/models/mask_head.py``).

MaskRCNNFPNFeatureExtractor (14x14 pooled -> 4x conv256) and
MaskRCNNC4Predictor (2x2/2 deconv + 1x1 logits); the CSPN baseline's
PRCNNFeatureExtractor (a conv tower over the raw image, pooled at four
scales into 25x25 bins by kernel K2 and fused) and PRCNNPredictor. Activations run NCHW in
channels_last memory; the head's inputs and outputs keep the JAX layouts
([N, P, P, C] features, [B, K, R, R, classes] logits). In training the
head sees the first ``MASK_MAX_POS`` positive RoIs of each image, its
targets are the matched gt masks cropped to the RoI by ROIAlign at the
output resolution and thresholded at 0.5 (``crop_masks_to_boxes``), and
the loss is the BCE of the gt class's channel over the positives' pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses as L
from ..ops.pooler import _axis_samples, multilevel_roi_align
from ..ops.topk import top_k
from ..parallel import comm
from .layers import Conv2d, ConvTranspose2d, variance_scaling_

_CROP_ROI_CHUNK = 32


def kaiming_init(module: nn.Module, gen: torch.Generator):
    """flax variance_scaling(2.0, "fan_out", "normal") on every conv, bias 0."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            variance_scaling_(m.weight, 2.0, "fan_out", "normal", gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, ConvTranspose2d):
            # torch keeps [in, out, kh, kw]: flax's fan_out is shape[1] * k
            variance_scaling_(m.weight, 2.0, "fan_in", "normal", gen)
            nn.init.zeros_(m.bias)


class MaskRCNNFPNExtractor(nn.Module):
    def __init__(self, in_channels: int = 256, layers=(256, 256, 256, 256)):
        super().__init__()
        self.n = len(layers)
        for i, ch in enumerate(layers):
            setattr(self, f"mask_fcn{i + 1}", Conv2d(in_channels, ch, 3, padding=1))
            in_channels = ch

    def forward(self, x):
        """x NCHW (channels_last) -> NCHW."""
        for i in range(self.n):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return x


class MaskRCNNC4Predictor(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 3, dim_reduced: int = 256):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1)

    def forward(self, x):
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class PRCNNExtractor(nn.Module):
    """The CSPN baseline's extractor (reference roi_mask_feature_extractors.py:
    9-88; JAX ``PRCNNExtractor``): two 3x3 convs at each of four scales of
    the raw image (32, 64, 128, 256 channels, a 3x3/2 max-pool between
    scales), each scale's output ROIAligned in float32 at its own stride
    (1, 1/2, 1/4, 1/8) into 25x25 bins, the four concatenated (480
    channels), then ``posconv1`` (480 -> 256, relu) and ``posconv2``
    (256 -> 32). Every scale is one launch of kernel K2 with one level, and
    its backward one launch of K3."""

    CHANNELS = ((32, 32), (64, 64), (128, 128), (256, 256))

    def __init__(self, pool_size: int = 25, sampling: int = 2):
        super().__init__()
        self.pool_size, self.sampling = pool_size, sampling
        in_ch = 3
        for stage, (c1, c2) in enumerate(self.CHANNELS):
            setattr(self, f"conv{2 * stage + 1}", Conv2d(in_ch, c1, 3, padding=1))
            setattr(self, f"conv{2 * stage + 2}", Conv2d(c1, c2, 3, padding=1))
            in_ch = c2
        self.posconv1 = Conv2d(sum(c for _, c in self.CHANNELS), 256, 3, padding=1)
        self.posconv2 = Conv2d(256, 32, 3, padding=1)

    def forward(self, images, boxes, dtype: torch.dtype):
        """images [B, H, W, 3] (normalized); boxes [B, S, 4] in image
        coordinates; the convs run in ``dtype``. Returns [B*S, 32, P, P]
        NCHW in channels_last memory."""
        b, s = boxes.shape[:2]
        x = images.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pooled = []
        for stage in range(len(self.CHANNELS)):
            x = F.relu(getattr(self, f"conv{2 * stage + 1}")(x))
            x = F.relu(getattr(self, f"conv{2 * stage + 2}")(x))
            # an NHWC view of the channels_last map, contiguous as K2 wants it
            level = x.float().permute(0, 2, 3, 1)
            pooled.append(multilevel_roi_align([level], boxes, (0.5**stage,), self.pool_size, self.sampling))
            if stage < len(self.CHANNELS) - 1:
                x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        p = self.pool_size
        cat = torch.cat(pooled, dim=-1).reshape(b * s, p, p, -1)
        cat = cat.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.posconv2(F.relu(self.posconv1(cat)))


class PRCNNPredictor(nn.Module):
    """relu, then 1x1 logits (roi_mask_predictors.py:39-53)."""

    def __init__(self, in_channels: int = 32, num_classes: int = 3):
        super().__init__()
        self.mask_fcn_logits = Conv2d(in_channels, num_classes, 1)

    def forward(self, x):
        return self.mask_fcn_logits(F.relu(x))


def select_mask_probs(mask_logits, labels):
    """Per-detection sigmoid of its label's channel: [B, K, R, R, C] -> [B, K, R, R]."""
    lab = labels.clamp(min=0).long()
    idx = lab[:, :, None, None, None].expand(*mask_logits.shape[:4], 1)
    return torch.sigmoid(torch.gather(mask_logits.float(), -1, idx)[..., 0])


def select_positive_rois(rois, max_pos: int):
    """The first ``max_pos`` positive RoIs of each image, in slot order:
    (boxes [B, K, 4], labels [B, K] (0 where not positive), matched gt
    rows [B, K], valid [B, K])."""
    max_pos = min(max_pos, rois.boxes.shape[1])
    _, idx = top_k(rois.is_pos.float(), max_pos)  # stable: first positives first
    v = torch.gather(rois.is_pos, 1, idx)
    return (torch.gather(rois.boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.where(v, torch.gather(rois.labels, 1, idx), 0),
            torch.gather(rois.matched_gt, 1, idx), v)


def _dense_axis_weights(start, size, pooled: int, grid: int, dim: int):
    """The JAX package's per-axis interpolation matrix A [R, pooled, dim]
    (``ops/roi_align.py::_axis_weights``), built the same way: a weighted
    one-hot per sample, summed over the bin's samples."""
    low, high, w_low, w_high = _axis_samples(start, size, pooled, grid, torch.full_like(start, float(dim)))
    r = start.shape[0]
    oh = lambda i: F.one_hot(i, dim).float()  # noqa: E731
    a = w_low[..., None] * oh(low) + w_high[..., None] * oh(high)  # [R, P*G, dim]
    return a.reshape(r, pooled, grid, dim).sum(2)


def crop_masks_to_boxes(gt_masks, gt_idx, boxes, resolution: int):
    """Project each RoI's gt mask into the RoI at resolution x resolution:
    single-level ROIAlign (scale 1, 2x2 samples) of the full-image mask,
    then >= 0.5. gt_masks [B, M, Hm, Wm]; gt_idx [B, S] rows of it; boxes
    [B, S, 4] in mask coordinates. Returns f32 [B, S, R, R].

    The two contractions follow the JAX ``roi_align`` (rows, then columns)
    so that values on the 0.5 threshold round the same way. Plain PyTorch:
    the JAX package runs this on XLA, not in a Pallas kernel."""
    b, s = gt_idx.shape
    m, hm, wm = gt_masks.shape[1:]
    flat_masks = gt_masks.reshape(b * m, hm, wm)
    rows = (torch.arange(b, device=gt_idx.device)[:, None] * m + gt_idx).reshape(-1)
    bx = boxes.reshape(-1, 4).float()
    start_x, start_y = bx[:, 0], bx[:, 1]
    roi_w = (bx[:, 2] - start_x).clamp(min=1.0)
    roi_h = (bx[:, 3] - start_y).clamp(min=1.0)
    out = []
    for lo in range(0, b * s, _CROP_ROI_CHUNK):
        sl = slice(lo, lo + _CROP_ROI_CHUNK)
        ay = _dense_axis_weights(start_y[sl], roi_h[sl], resolution, 2, hm)  # [r, R, Hm]
        ax = _dense_axis_weights(start_x[sl], roi_w[sl], resolution, 2, wm)  # [r, R, Wm]
        tmp = torch.bmm(ay, flat_masks[rows[sl]].float())  # [r, R, Wm]
        out.append(torch.bmm(tmp, ax.transpose(1, 2)))  # [r, R, R]
    return (torch.cat(out) >= 0.5).float().reshape(b, s, resolution, resolution)


def mask_head_loss(mask_logits, mask_targets, labels, valid):
    """Mean BCE of the gt class's channel over the positives' pixels.
    mask_logits [B, S, R, R, C]; mask_targets [B, S, R, R]; labels, valid [B, S]."""
    lab = labels.clamp(min=0).long()
    sel = torch.gather(mask_logits.float(), -1, lab[:, :, None, None, None].expand(*mask_logits.shape[:4], 1))[..., 0]
    w = valid.float()[:, :, None, None]
    denom = (comm.global_sum(w.sum()) * sel.shape[-1] * sel.shape[-2]).clamp(min=1.0)
    return (L.bce_with_logits(sel, mask_targets) * w).sum() / denom
