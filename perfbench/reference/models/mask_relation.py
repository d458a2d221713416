"""IR-Net mask relation refinement (port of ``mmt_psm_tpu/models/mask_relation.py``).

Each instance's own-class 28x28 mask logit is sigmoided and max-pooled to
14x14. The feature extractor (FEATURE_EXTRACTOR,
relation_mask_feature_extractor.py:140-152) makes the maps the attention
refines: RoiAlign/SameSizeRoiAlignMaskFeatureExtractor concatenate the
pooled mask to the instance's 256-channel mask feature and reduce the 257
channels to EXTRACTOR_CHANNEL with a conv stack; DeepFeatureExtractor runs
the stack on the mask feature alone; MaskFeatureExtractor takes the pooled
mask alone (1 channel); SameFeatureMask passes the mask feature through.
Then CIAM (cross-instance channel attention within a class, masked to
same-class valid pairs) or, for any other TYPE, CAM (channel attention
within each instance),
and a 2x2 deconv and a 1x1 classifier give per-class 28x28 logits again;
with SAME_PREDICTOR the refined maps and the keep mask go back to the
detector, which runs them through the mask head's own predictor. Rows of
invalid instances keep their first-pass logits. The attention core runs
in float32, batched over images. ``ShapeBuffer`` is the learnable bank of
per-class shape centres (relation_mask_feature_extractor.py:156-169),
which no graph of the JAX package reads.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d, normal_
from .mask_head import kaiming_init


@dataclasses.dataclass(frozen=True)
class MaskRelationConfig:
    type: str = "CIAM"
    extractor_channel: int = 16
    deep_super: bool = True
    norm: int = -1
    pre_norm: bool = False
    num_classes: int = 3
    extractor: str = "RoiAlignMaskFeatureExtractor"
    same_predictor: bool = False
    compute_dtype: str = "float32"

    @classmethod
    def from_cfg(cls, cfg):
        r = cfg.MODEL.RELATION_MASK
        return cls(
            type=r.TYPE,
            extractor_channel=r.EXTRACTOR_CHANNEL,
            deep_super=r.DEEP_SUPER,
            norm=r.NORM,
            pre_norm=r.PRE_NORM,
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            extractor=r.FEATURE_EXTRACTOR,
            same_predictor=r.SAME_PREDICTOR,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        )


def ciam_attention(x, labels, valid, gamma, norm: int, pre_norm: bool):
    """Cross-instance channel attention, class-block masked.

    x [B, S, H, W, C]; labels/valid [B, S]. Returns x's shape and dtype.
    """
    bsz, s = labels.shape
    xf = x.float()
    if pre_norm:
        nrm = torch.sqrt((xf.reshape(bsz, s, -1) ** 2).sum(-1))
        cw = xf / nrm.clamp(min=1e-10)[:, :, None, None, None]
    else:
        cw = xf
    energy = torch.einsum("bihwc,bjhwc->bcij", cw, cw)  # per-channel Gram [B, C, S, S]
    same = (labels[:, :, None] == labels[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    if norm == 1:
        weight = torch.abs(energy.reshape(*energy.shape[:2], -1).sum(-1))  # [B, C]
        weight = weight / weight.amax(-1, keepdim=True).clamp(min=1e-10)
        energy = energy * weight[..., None, None]
    neg = -1e30
    same_c = same[:, None]
    masked_e = torch.where(same_c, energy, neg)
    row_max = masked_e.amax(-1, keepdim=True)
    rescaled = torch.where(same_c, row_max - energy, neg)
    mean_e = torch.where(same, torch.where(same_c, rescaled, 0.0).mean(1), neg)  # [B, S, S]
    attention = torch.softmax(mean_e, dim=-1)
    attention = torch.where(valid[:, :, None], attention, 0.0)
    out = (attention @ xf.reshape(bsz, s, -1)).reshape(x.shape)
    return (gamma * out + xf).to(x.dtype)


def cam_attention(x, gamma):
    """Channel attention within each instance (CAM_Module). x [B, S, H, W, C]."""
    b, s, h, w, c = x.shape
    xf = x.float()
    q = xf.reshape(b, s, h * w, c).transpose(-1, -2)  # [B, S, C, HW]
    energy = q @ q.transpose(-1, -2)  # [B, S, C, C]
    attention = torch.softmax(energy.amax(-1, keepdim=True) - energy, dim=-1)
    out = (attention @ q).transpose(-1, -2).reshape(x.shape)
    return (gamma * out + xf).to(x.dtype)


# extractors that run the conv stack, and whether the pooled mask joins its input
_CONV_STACK = {"RoiAlignMaskFeatureExtractor": True, "SameSizeRoiAlignMaskFeatureExtractor": True,
               "DeepFeatureExtractor": False}
EXTRACTORS = (*_CONV_STACK, "MaskFeatureExtractor", "SameFeatureMask")


class MaskRelationRefineNet(nn.Module):
    """Held under ``roi_heads.mask.mask_relation_module`` with the
    reference's submodule names. ``roi_channels``: those of the mask
    features, which the mask head's predictor also takes."""

    def __init__(self, config: MaskRelationConfig, roi_channels: int = 256):
        super().__init__()
        if config.extractor not in EXTRACTORS:
            raise ValueError(f"unknown relation mask extractor {config.extractor!r}")
        self.config = config
        if config.extractor in _CONV_STACK:
            ext = nn.Module()
            in_ch = roi_channels + 1 if _CONV_STACK[config.extractor] else roi_channels
            for i in range(3):
                setattr(ext, f"mask_fcn{i + 1}", Conv2d(in_ch if i == 0 else 256, 256, 3, padding=1))
            ext.conv5_mask = Conv2d(256, config.extractor_channel, 3, padding=1)
            self.appearance_feature_extractor = ext
            out_ch = config.extractor_channel
        else:
            out_ch = 1 if config.extractor == "MaskFeatureExtractor" else roi_channels
        self.relation_module = nn.Module()
        self.relation_module.gamma = nn.Parameter(torch.zeros(1))
        if config.same_predictor:
            if out_ch != roi_channels:
                # the JAX model fails here too: the shared predictor takes the mask features' channels
                raise ValueError(f"SAME_PREDICTOR feeds the mask predictor ({roi_channels} channels) with "
                                 f"the {config.extractor} output of {out_ch} channels")
        else:
            self.deconv_1 = ConvTranspose2d(out_ch, out_ch, 2, stride=2)
            self.classifier = Conv2d(out_ch, config.num_classes, 1)

    def init_weights(self, gen: torch.Generator):
        kaiming_init(self, gen)
        # flax starts gamma at 0, which would leave the attention inert in a
        # model with random weights; start it inside (0, 1) so it contributes
        with torch.no_grad():
            self.relation_module.gamma.uniform_(0.25, 0.75, generator=gen)

    def forward(self, roi_feats, mask_logits, labels, valid):
        """roi_feats [B, S, P, P, Cr] (mask extractor output, NHWC);
        mask_logits [B, S, 2P, 2P, C]; labels/valid [B, S]. Returns refined
        logits, or with SAME_PREDICTOR (refined maps [B*S, E, P, P] NCHW,
        keep [B, S, 1, 1, 1])."""
        c = self.config
        dt = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        bsz, s, p = roi_feats.shape[:3]
        r = mask_logits.shape[2]
        lab = labels.clamp(min=0).long()
        own = torch.gather(mask_logits, -1, lab[:, :, None, None, None].expand(bsz, s, r, r, 1))[..., 0]
        m = torch.sigmoid(own.float()).reshape(bsz * s, 1, r, r)
        mp = F.max_pool2d(m, 2, 2).to(dt)  # [BS, 1, P, P]

        roi = roi_feats.reshape(bsz * s, p, p, -1).permute(0, 3, 1, 2).to(dt)
        if c.extractor in _CONV_STACK:
            x = torch.cat([roi, mp], dim=1) if _CONV_STACK[c.extractor] else roi
            x = x.contiguous(memory_format=torch.channels_last)
            ext = self.appearance_feature_extractor
            for i in range(3):
                x = F.relu(getattr(ext, f"mask_fcn{i + 1}")(x))
            x = F.relu(ext.conv5_mask(x))  # [BS, E, P, P]
        else:
            x = mp if c.extractor == "MaskFeatureExtractor" else roi

        xh = x.permute(0, 2, 3, 1).reshape(bsz, s, p, p, -1)
        gamma = self.relation_module.gamma
        if c.type == "CIAM":
            xh = ciam_attention(xh, labels, valid, gamma, c.norm, c.pre_norm)
        else:
            xh = cam_attention(xh, gamma)
        x = xh.reshape(bsz * s, p, p, -1).permute(0, 3, 1, 2)
        keep = (valid & (labels > 0))[:, :, None, None, None]
        if c.same_predictor:
            return x.contiguous(memory_format=torch.channels_last), keep
        x = F.relu(self.deconv_1(x))
        refined = self.classifier(x).permute(0, 2, 3, 1).reshape(bsz, s, r, r, -1)
        return torch.where(keep, refined.to(mask_logits.dtype), mask_logits)


class ShapeBuffer(nn.Module):
    """Learnable per-class mask shape centres: ``center`` [2 K, R, R, 1]
    (the JAX layout), Xavier-normal (not truncated) at flax's fan-average
    variance."""

    def __init__(self, center_per_class: int = 8, resolution: int = 28):
        super().__init__()
        self.center = nn.Parameter(torch.zeros(2 * center_per_class, resolution, resolution, 1))

    def init_weights(self, gen: torch.Generator):
        # flax fans of a [..., in, out] kernel: receptive field = prod of the leading axes
        receptive = self.center.shape[0] * self.center.shape[1]
        fan_avg = (self.center.shape[2] + self.center.shape[3]) * receptive / 2
        normal_(self.center, (1.0 / fan_avg) ** 0.5, gen)

    def forward(self):
        return self.center
