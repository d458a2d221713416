"""IR-Net mask relation refinement on the CIAM path (port of
``mmt_psm_tpu/models/mask_relation.py``).

Each instance's own-class 28x28 mask logit is sigmoided, max-pooled to
14x14 and concatenated with its 256-channel mask feature; a conv stack
reduces that to EXTRACTOR_CHANNEL maps; CIAM (cross-instance channel
attention within a class, masked to same-class valid pairs) refines them;
a 2x2 deconv and a 1x1 classifier give per-class 28x28 logits again. Rows
of invalid instances keep their first-pass logits. The attention core
runs in float32, batched over images.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d
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


class MaskRelationRefineNet(nn.Module):
    """Held under ``roi_heads.mask.mask_relation_module`` with the
    reference's submodule names."""

    def __init__(self, config: MaskRelationConfig, roi_channels: int = 256):
        super().__init__()
        if (config.type, config.extractor, config.same_predictor) != ("CIAM", "RoiAlignMaskFeatureExtractor", False):
            raise NotImplementedError(
                f"the port runs the CIAM + RoiAlignMaskFeatureExtractor path only, got {config}"
            )
        self.config = config
        ext = nn.Module()
        for i in range(3):
            setattr(ext, f"mask_fcn{i + 1}", Conv2d(roi_channels + 1 if i == 0 else 256, 256, 3, padding=1))
        ext.conv5_mask = Conv2d(256, config.extractor_channel, 3, padding=1)
        self.appearance_feature_extractor = ext
        self.relation_module = nn.Module()
        self.relation_module.gamma = nn.Parameter(torch.zeros(1))
        self.deconv_1 = ConvTranspose2d(config.extractor_channel, config.extractor_channel, 2, stride=2)
        self.classifier = Conv2d(config.extractor_channel, config.num_classes, 1)

    def init_weights(self, gen: torch.Generator):
        kaiming_init(self, gen)
        # flax starts gamma at 0, which would leave CIAM inert in a model
        # with random weights; start it inside (0, 1) so CIAM contributes
        with torch.no_grad():
            self.relation_module.gamma.uniform_(0.25, 0.75, generator=gen)

    def forward(self, roi_feats, mask_logits, labels, valid):
        """roi_feats [B, S, P, P, 256] (mask extractor output, NHWC);
        mask_logits [B, S, 2P, 2P, C]; labels/valid [B, S]."""
        c = self.config
        dt = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        bsz, s, p = roi_feats.shape[:3]
        r = mask_logits.shape[2]
        lab = labels.clamp(min=0).long()
        own = torch.gather(mask_logits, -1, lab[:, :, None, None, None].expand(bsz, s, r, r, 1))[..., 0]
        m = torch.sigmoid(own.float()).reshape(bsz * s, 1, r, r)
        mp = F.max_pool2d(m, 2, 2).to(dt)  # [BS, 1, P, P]

        x = roi_feats.reshape(bsz * s, p, p, -1).permute(0, 3, 1, 2).to(dt)
        x = torch.cat([x, mp], dim=1).contiguous(memory_format=torch.channels_last)
        ext = self.appearance_feature_extractor
        for i in range(3):
            x = F.relu(getattr(ext, f"mask_fcn{i + 1}")(x))
        x = F.relu(ext.conv5_mask(x))  # [BS, E, P, P]

        xh = x.permute(0, 2, 3, 1).reshape(bsz, s, p, p, -1)
        xh = ciam_attention(xh, labels, valid, self.relation_module.gamma, c.norm, c.pre_norm)
        x = xh.reshape(bsz * s, p, p, -1).permute(0, 3, 1, 2)
        x = F.relu(self.deconv_1(x))
        refined = self.classifier(x).permute(0, 2, 3, 1).reshape(bsz, s, r, r, -1)
        keep = (valid & (labels > 0))[:, :, None, None, None]
        return torch.where(keep, refined.to(mask_logits.dtype), mask_logits)
