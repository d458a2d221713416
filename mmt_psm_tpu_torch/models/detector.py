"""Mask R-CNN and its variants: every graph of the JAX ``ModelConfig.from_cfg``.

Port of ``mmt_psm_tpu/models/detector.py`` (``ModelConfig``,
``MaskRCNN.forward_test``, ``detections_from_features`` and
``forward_train``, and the mean teacher's sub-forwards and ``HintAdaptor``):
backbone -> RPN -> box head -> relation-NMS or the greedy (or set-NMS)
post-processor -> mask head -> mask relation, all on padded fixed shapes
with no host sync; at test time per-label mask probabilities, in training
the loss dict. The flagship is R-50-FPN with relation-NMS and CIAM; the
config also selects the R-50-C4 family (one stride-16 level, the stage-5
RoI head shared by the box and mask heads), the PRCNN mask head over the
raw image, the relation module's other variants, RPN_ONLY (the proposals
are the detections) and backbone recomputation in the backward.
Submodules carry maskrcnn-benchmark's names (``backbone.body``,
``rpn.head``, ``roi_heads.box``, ``roi_heads.mask``, ``relation_nms``),
so ``state_dict`` keys match the reference checkpoint; a train-mode model
of a config with MT.FG_HINT > 0 adds the MGD ``hint_adaptor``.

``build_model`` is the entry point: the flagship config, seeded random
weights, eval mode, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
from torch import nn
from torch.profiler import record_function

from ..config import get_cfg
from ..ops import sampler
from ..ops.pooler import multilevel_roi_align
from ..structures.detections import Detections, GroundTruth
from .anchors import fpn_anchors
from .backbone import ResNetC4Backbone, ResNetFPNBackbone
from .box_head import FPN2MLPExtractor, FPNPredictor, box_head_loss, postprocess_boxes, subsample_proposals
from .c4 import FastRCNNPredictor, ResNet50Conv5ROIExtractor
from .layers import Conv2d, variance_scaling_
from .mask_head import (MaskRCNNC4Predictor, MaskRCNNFPNExtractor, PRCNNExtractor, PRCNNPredictor,
                        crop_masks_to_boxes, kaiming_init, mask_head_loss, select_mask_probs, select_positive_rois)
from .mask_relation import MaskRelationConfig, MaskRelationRefineNet
from .relation import RelationNMS, RelationNMSConfig, relation_nms_inference, relation_nms_loss
from .rpn import RPN, rpn_loss, select_proposals

FLAGSHIP_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "pap", "mmt_psm_r50_fpn.yaml",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The static hyperparameters of the test-time and training graphs (the
    subset of the JAX ``ModelConfig`` they read, same names)."""

    image_size: int = 1024
    num_classes: int = 3
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_strides: tuple = (4, 8, 16, 32, 64)
    aspect_ratios: tuple = (0.5, 1.0, 2.0)
    straddle_thresh: float = 0.0
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    pre_nms_top_n_train: int = 2000
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_train: int = 2000
    post_nms_top_n_test: int = 1000
    fpn_post_nms_top_n_train: int = 2000
    fpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 0.0
    box_fg_iou: float = 0.5
    box_bg_iou: float = 0.5
    box_batch_per_image: int = 512
    box_positive_fraction: float = 0.25
    reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    pooler_scales: tuple = (0.25, 0.125, 0.0625, 0.03125)
    box_pooler_resolution: int = 7
    box_pooler_sampling: int = 2
    mlp_dim: int = 1024
    box_head_dropout: float = 0.0
    # the post-processor without relation-NMS
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 200
    # "greedy" (per-class NMS on the card) or "set" (K_HEAD > 1: the card
    # tags each detection with its proposal, the host runs set-NMS)
    nms_type: str = "greedy"
    mask_on: bool = True
    mask_pooler_resolution: int = 14
    mask_pooler_sampling: int = 2
    mask_max_pos: int = 128
    # "MaskRCNNFPNFeatureExtractor", "ResNet50Conv5ROIFeatureExtractor" (the
    # C4 box head's stage-5 extractor, shared) or "PRCNNFeatureExtractor"
    mask_extractor: str = "MaskRCNNFPNFeatureExtractor"
    # proposals-only model (MODEL.RPN_ONLY): no RoI heads
    rpn_only: bool = False
    # "R-50-FPN" / "R-101-FPN" (pyramid) or "R-50-C4" / "R-50-C5" (one level)
    conv_body: str = "R-50-FPN"
    # "FPN2MLPFeatureExtractor" (fc6/fc7) or "ResNet50Conv5ROIFeatureExtractor" (stage-5 head)
    box_extractor: str = "FPN2MLPFeatureExtractor"
    backbone_out_channels: int = 256
    freeze_at: int = 2
    compute_dtype: str = "bfloat16"
    # recompute each backbone bottleneck in the backward (TPU.REMAT_BACKBONE)
    remat_backbone: bool = False
    # mean-teacher hint adaptor (MGD): a 1x1 conv per FPN level (MT.T_ADAPT)
    with_hint_adaptor: bool = False
    hint_dim: int = 128
    with_relation_nms: bool = True
    relation: Any = RelationNMSConfig()
    with_relation_mask: bool = True
    relation_mask: Any = MaskRelationConfig()

    @classmethod
    def from_cfg(cls, cfg, train: bool = False) -> "ModelConfig":
        """The graph ``cfg`` asks for, read as the JAX ``from_cfg`` reads it;
        ``train`` adds the MGD hint adaptor where MT.FG_HINT > 0, as the JAX
        ``from_cfg(cfg, train=True)`` does (inference builds none)."""
        m = cfg.MODEL
        use_rel_nms = bool(m.RELATION_NMS.USE_RELATION_NMS)
        use_rel_mask = bool(m.RELATION_MASK.USE_RELATION)
        return cls(
            with_hint_adaptor=bool(train and cfg.MT.FG_HINT > 0),
            image_size=cfg.TPU.IMAGE_SIZE,
            num_classes=m.ROI_BOX_HEAD.NUM_CLASSES,
            anchor_sizes=tuple(m.RPN.ANCHOR_SIZES),
            anchor_strides=tuple(m.RPN.ANCHOR_STRIDE),
            aspect_ratios=tuple(m.RPN.ASPECT_RATIOS),
            straddle_thresh=float(m.RPN.STRADDLE_THRESH),
            rpn_fg_iou=m.RPN.FG_IOU_THRESHOLD,
            rpn_bg_iou=m.RPN.BG_IOU_THRESHOLD,
            rpn_batch_per_image=m.RPN.BATCH_SIZE_PER_IMAGE,
            rpn_positive_fraction=m.RPN.POSITIVE_FRACTION,
            pre_nms_top_n_train=m.RPN.PRE_NMS_TOP_N_TRAIN,
            pre_nms_top_n_test=m.RPN.PRE_NMS_TOP_N_TEST,
            post_nms_top_n_train=m.RPN.POST_NMS_TOP_N_TRAIN,
            post_nms_top_n_test=m.RPN.POST_NMS_TOP_N_TEST,
            fpn_post_nms_top_n_train=m.RPN.FPN_POST_NMS_TOP_N_TRAIN,
            fpn_post_nms_top_n_test=m.RPN.FPN_POST_NMS_TOP_N_TEST,
            rpn_nms_thresh=m.RPN.NMS_THRESH,
            rpn_min_size=float(m.RPN.MIN_SIZE),
            box_fg_iou=m.ROI_HEADS.FG_IOU_THRESHOLD,
            box_bg_iou=m.ROI_HEADS.BG_IOU_THRESHOLD,
            box_batch_per_image=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            box_positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
            reg_weights=tuple(m.ROI_HEADS.BBOX_REG_WEIGHTS),
            pooler_scales=tuple(m.ROI_BOX_HEAD.POOLER_SCALES),
            box_pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
            # the reference's sampling ratio 0 (adaptive) is data-dependent; the pap configs use 2
            box_pooler_sampling=m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO or 2,
            mlp_dim=m.ROI_BOX_HEAD.MLP_HEAD_DIM,
            box_head_dropout=m.ROI_BOX_HEAD.DO,
            score_thresh=m.ROI_HEADS.SCORE_THRESH,
            nms_thresh=m.ROI_HEADS.NMS,
            detections_per_img=m.ROI_HEADS.DETECTIONS_PER_IMG,
            # set-NMS needs both switches (box_head/inference.py:120-122)
            nms_type="set" if m.ROI_HEADS.NMS_TYPE == "set" and m.ROI_BOX_HEAD.K_HEAD > 1 else "greedy",
            rpn_only=bool(m.RPN_ONLY),
            mask_on=bool(m.MASK_ON and not m.RPN_ONLY),
            mask_pooler_resolution=m.ROI_MASK_HEAD.POOLER_RESOLUTION,
            mask_pooler_sampling=m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO or 2,
            mask_extractor=m.ROI_MASK_HEAD.FEATURE_EXTRACTOR,
            conv_body=m.BACKBONE.CONV_BODY,
            box_extractor=m.ROI_BOX_HEAD.FEATURE_EXTRACTOR,
            backbone_out_channels=m.BACKBONE.OUT_CHANNELS,
            freeze_at=m.BACKBONE.FREEZE_CONV_BODY_AT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            remat_backbone=bool(cfg.TPU.REMAT_BACKBONE),
            with_relation_nms=use_rel_nms,
            relation=RelationNMSConfig.from_cfg(cfg) if use_rel_nms else None,
            with_relation_mask=use_rel_mask,
            relation_mask=MaskRelationConfig.from_cfg(cfg) if use_rel_mask else None,
        )


class HintAdaptor(nn.Module):
    """One 1x1 conv per FPN level, 256 -> ``out_dim``: the MGD embedding
    (reference MaskRCNNFPNAdaptor, roi_box_feature_extractors.py:45-75;
    JAX ``HintAdaptor``). State names ``adapter_1`` .. ``adapter_5``."""

    def __init__(self, in_channels: int = 256, out_dim: int = 128, levels: int = 5):
        super().__init__()
        for i in range(levels):
            setattr(self, f"adapter_{i + 1}", Conv2d(in_channels, out_dim, 1))
        self.levels = levels

    def init_weights(self, gen: torch.Generator):
        for i in range(self.levels):
            conv = getattr(self, f"adapter_{i + 1}")
            variance_scaling_(conv.weight, 1.0 / 3, "fan_in", "uniform", gen)
            nn.init.zeros_(conv.bias)

    def forward(self, features):
        """NHWC levels -> NHWC embeddings [B, H_l, W_l, out_dim]."""
        return [getattr(self, f"adapter_{i + 1}")(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                for i, f in enumerate(features)]


C4_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"


class MaskRCNN(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        c = self.config = config
        if c.conv_body.endswith("-FPN"):
            self.backbone = ResNetFPNBackbone(c.conv_body, c.backbone_out_channels, freeze_at=c.freeze_at,
                                              remat=c.remat_backbone)
            ch = rpn_ch = c.backbone_out_channels
            num_anchors = len(c.aspect_ratios)
        else:
            # C4 family: one level (C4, or C5), every anchor size on it, a
            # 1024-channel RPN conv as in the JAX model
            self.backbone = ResNetC4Backbone(c.conv_body, freeze_at=c.freeze_at, remat=c.remat_backbone)
            ch, rpn_ch = self.backbone.body.out_channels, 1024
            num_anchors = len(c.aspect_ratios) * len(c.anchor_sizes)
        self.rpn = RPN(rpn_ch, num_anchors, in_channels=ch)
        if not c.rpn_only:
            self.roi_heads = nn.Module()
            box = nn.Module()
            if c.box_extractor == C4_EXTRACTOR:
                box.feature_extractor = ResNet50Conv5ROIExtractor(ch)
                box.predictor = FastRCNNPredictor(2048, c.num_classes)
            else:
                box.feature_extractor = FPN2MLPExtractor(ch, c.box_pooler_resolution, c.mlp_dim, c.box_head_dropout)
                box.predictor = FPNPredictor(c.mlp_dim, c.num_classes)
            self.roi_heads.box = box
            if c.mask_on:
                mask = nn.Module()
                if c.mask_extractor == "PRCNNFeatureExtractor":
                    mask.feature_extractor = PRCNNExtractor()
                    mask.predictor = PRCNNPredictor(32, c.num_classes)
                    feat_ch = 32
                elif c.mask_extractor == C4_EXTRACTOR:
                    # shares the box head's stage-5 extractor
                    # (SHARE_BOX_FEATURE_EXTRACTOR); only the predictor is its own
                    if c.box_extractor != C4_EXTRACTOR:
                        raise ValueError(f"the {C4_EXTRACTOR} mask head shares the box head's, "
                                         f"but the box head is {c.box_extractor}")
                    mask.predictor = MaskRCNNC4Predictor(2048, c.num_classes)
                    feat_ch = 2048
                else:
                    mask.feature_extractor = MaskRCNNFPNExtractor(ch)
                    mask.predictor = MaskRCNNC4Predictor(256, c.num_classes)
                    feat_ch = 256
                if c.with_relation_mask:
                    mask.mask_relation_module = MaskRelationRefineNet(c.relation_mask, feat_ch)
                self.roi_heads.mask = mask
            if c.with_relation_nms:
                self.relation_nms = RelationNMS(c.relation)
        if c.with_hint_adaptor:
            self.hint_adaptor = HintAdaptor(ch, c.hint_dim, len(c.anchor_strides))
        levels = fpn_anchors(c.image_size, c.anchor_strides, c.anchor_sizes, c.aspect_ratios)
        for i, a in enumerate(levels):
            self.register_buffer(f"anchors_{i}", torch.from_numpy(a), persistent=False)
        self.num_levels = len(levels)
        self.eval()

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32

    def init_weights(self, gen: torch.Generator) -> "MaskRCNN":
        """Seeded random weights of the JAX initialisers' scales."""
        c = self.config
        self.backbone.init_weights(gen)
        self.rpn.head.init_weights(gen)
        if not c.rpn_only:
            self.roi_heads.box.feature_extractor.init_weights(gen)
            self.roi_heads.box.predictor.init_weights(gen)
            if c.mask_on:
                mask = self.roi_heads.mask
                if hasattr(mask, "feature_extractor"):
                    kaiming_init(mask.feature_extractor, gen)
                kaiming_init(mask.predictor, gen)
                if c.with_relation_mask:
                    mask.mask_relation_module.init_weights(gen)
            if c.with_relation_nms:
                self.relation_nms.init_weights(gen)
        if c.with_hint_adaptor:
            self.hint_adaptor.init_weights(gen)
        return self

    @property
    def anchors(self):
        return [getattr(self, f"anchors_{i}") for i in range(self.num_levels)]

    @torch.no_grad()
    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Detections:
        """images f32 [B, H, W, 3] (normalized, padded to the canvas);
        image_sizes int [B, 2] true (h, w). Returns padded Detections."""
        return self.forward_test(images, image_sizes)

    def forward_train(self, images, image_sizes, gt: GroundTruth, gen: torch.Generator) -> dict:
        """The supervised losses of one batch (the JAX ``forward_train``).

        images f32 [B, H, W, 3] normalized on the canvas; image_sizes int
        [B, 2]; gt padded ground truth with full-image masks; ``gen`` (on
        the images' device) draws the sampler's uniforms and the dropout
        masks. Returns ``loss_objectness`` and ``loss_rpn_box_reg`` (all
        an RPN-only model has), ``loss_classifier``, ``loss_box_reg``,
        ``nms_loss`` with relation-NMS and ``loss_mask`` with a mask head,
        scalar tensors; nothing here waits on the card."""
        c = self.config
        dev = images.device
        with record_function("backbone"):
            features = self.backbone_features(images)
        with record_function("rpn_head"):
            objectness, box_reg = self.rpn(features)
        with record_function("rpn_loss"):
            r = sampler.uniform(gen, (images.shape[0], sum(a.shape[0] for a in self.anchors)), dev)
            loss_obj, loss_rpn_box = rpn_loss(
                r, objectness, box_reg, self.anchors, image_sizes, gt, fg_thresh=c.rpn_fg_iou,
                bg_thresh=c.rpn_bg_iou, batch_per_image=c.rpn_batch_per_image,
                positive_fraction=c.rpn_positive_fraction, straddle_thresh=c.straddle_thresh,
            )
        losses = {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_rpn_box}
        if c.rpn_only:
            return losses
        with record_function("rpn_select_proposals"):
            proposals = select_proposals(
                [o.detach() for o in objectness], [x.detach() for x in box_reg], self.anchors, image_sizes,
                pre_nms_top_n=c.pre_nms_top_n_train, post_nms_top_n=c.post_nms_top_n_train,
                fpn_post_nms_top_n=c.fpn_post_nms_top_n_train, nms_thresh=c.rpn_nms_thresh,
                min_size=c.rpn_min_size, is_train=True, gt=gt,
            )
        with record_function("box_head"):
            rois = subsample_proposals(
                sampler.uniform(gen, proposals.valid.shape, dev), proposals, gt,
                batch_size_per_image=c.box_batch_per_image, positive_fraction=c.box_positive_fraction,
                fg_thresh=c.box_fg_iou, bg_thresh=c.box_bg_iou, reg_weights=c.reg_weights,
            )
            class_logits, box_regression, box_feats = self.box_forward(features, rois.boxes, gen)
            losses["loss_classifier"], losses["loss_box_reg"] = box_head_loss(class_logits, box_regression, rois)
        if c.with_relation_nms:
            with record_function("relation_nms"):
                probs = torch.softmax(class_logits.float(), dim=-1)
                out = self.relation_nms(box_feats, probs, box_regression, rois.boxes, rois.valid, image_sizes)
                losses["nms_loss"] = relation_nms_loss(out, gt.boxes, gt.labels, gt.valid, c.relation)
        if c.mask_on:
            with record_function("mask_head"):
                with record_function("mask_head_targets"):
                    m_boxes, m_labels, m_gt_idx, m_valid = select_positive_rois(rois, c.mask_max_pos)
                mask_logits, mask_feats = self.mask_forward(features, m_boxes, images)
                with record_function("mask_head_targets"):
                    scale = gt.masks.shape[-1] / c.image_size
                    # the targets' resolution is the predictor's (25 for PRCNN)
                    targets = crop_masks_to_boxes(gt.masks, m_gt_idx, m_boxes * scale, mask_logits.shape[2])
                loss_mask = mask_head_loss(mask_logits, targets, m_labels, m_valid)
            if c.with_relation_mask:
                with record_function("mask_relation_ciam"):
                    refined = self.refine_masks(mask_logits, mask_feats, m_labels, m_valid)
                    loss_refined = mask_head_loss(refined, targets, m_labels, m_valid)
                # deep supervision 0.5 * (L1 + L2)
                loss_mask = 0.5 * (loss_mask + loss_refined) if c.relation_mask.deep_super else loss_refined
            losses["loss_mask"] = loss_mask
        return losses

    def forward_test(self, images, image_sizes) -> Detections:
        with record_function("backbone"):
            features = self.backbone_features(images)
        return self.detections_from_features(features, image_sizes, images)

    def pool(self, features, boxes, resolution: int, sampling: int):
        """Kernel K2 over the model's levels: [B, N, 4] -> [B, N, P, P, C]."""
        scales = self.config.pooler_scales
        return multilevel_roi_align(features[: len(scales)], boxes, scales, resolution, sampling)

    def box_forward(self, features, boxes, gen: torch.Generator | None = None, views: int = 1):
        """-> (class logits [B, S, C], box deltas [B, S, 4C], the relation
        head's features [B, S, D]: fc7, or the C4 head's spatial mean);
        ``gen`` draws the train-mode dropout masks, B holding ``views``
        stacked groups of the batch's images."""
        c = self.config
        pooled = self.pool(features, boxes, c.box_pooler_resolution, c.box_pooler_sampling)
        b, s = pooled.shape[:2]
        box = self.roi_heads.box
        flat = pooled.reshape(b * s, *pooled.shape[2:])
        if c.box_extractor == C4_EXTRACTOR:
            x = box.feature_extractor(flat)
            logits, regs = box.predictor(x)
            feats = x.mean(dim=(2, 3))
        else:
            feats = box.feature_extractor(flat, gen, views)
            logits, regs = box.predictor(feats)
        return logits.reshape(b, s, -1), regs.reshape(b, s, -1), feats.reshape(b, s, -1)

    def mask_forward(self, features, boxes, images=None):
        """-> (logits [B, K, R, R, classes], features [B, K, P, P, C]);
        ``images`` (normalized, [B, H, W, 3]) feed the PRCNN extractor."""
        c = self.config
        mask = self.roi_heads.mask
        b, s = boxes.shape[:2]
        if c.mask_extractor == "PRCNNFeatureExtractor":
            if images is None:
                raise ValueError("the PRCNN mask head reads the images: pass them")
            x = mask.feature_extractor(images, boxes, self.compute_dtype)
        else:
            pooled = self.pool(features, boxes, c.mask_pooler_resolution, c.mask_pooler_sampling)
            p = pooled.shape[2]
            flat = pooled.reshape(b * s, p, p, -1)
            if c.mask_extractor == C4_EXTRACTOR:
                x = self.roi_heads.box.feature_extractor(flat)  # float32, as in the JAX model
            else:
                x = mask.feature_extractor(flat.permute(0, 3, 1, 2))
        logits = mask.predictor(x.to(self.compute_dtype))
        r, p = logits.shape[-1], x.shape[-1]
        return (logits.permute(0, 2, 3, 1).reshape(b, s, r, r, -1),
                x.permute(0, 2, 3, 1).reshape(b, s, p, p, -1))

    def refine_masks(self, mask_logits, mask_feats, labels, valid):
        """The mask relation module; with SAME_PREDICTOR its refined maps
        go through the mask head's predictor."""
        mask = self.roi_heads.mask
        out = mask.mask_relation_module(mask_feats, mask_logits, labels, valid)
        if not self.config.relation_mask.same_predictor:
            return out
        x, keep = out
        b, s, r = mask_logits.shape[:3]
        refined = mask.predictor(x).permute(0, 2, 3, 1).reshape(b, s, r, r, -1)
        return torch.where(keep, refined.to(mask_logits.dtype), mask_logits)

    # -- sub-forwards of the mean-teacher step (JAX detector.py:366-406) --
    def backbone_features(self, images):
        """The feature pyramid P2..P6 (or the C4 level) of normalized NHWC
        images (extract_aug_feat's building block, generalized_rcnn.py:201-215)."""
        return self.backbone(images.to(self.compute_dtype))

    def hint_embeddings(self, features):
        """MGD embeddings of each level (generalized_rcnn.py:218-222)."""
        return self.hint_adaptor(features)

    def box_predictions(self, features, boxes, deterministic: bool = True, gen: torch.Generator | None = None,
                        views: int = 1):
        """Pool, box head and predictor on given per-image box sets
        (box_head.py:77-100): (class logits, box deltas, features).
        ``deterministic`` runs no dropout; else ``gen`` draws its masks,
        the boxes holding ``views`` stacked groups of the batch's images.
        The JAX ``roi_chunk`` bounds a TPU temporary of its pooling
        contraction; kernel K2 has no such temporary, so the port pools
        every RoI of the stacked views in one launch."""
        return self.box_forward(features, boxes, None if deterministic else gen, views)

    def teacher_proposals(self, features, image_sizes, pseudo_gt: GroundTruth):
        """Train-mode proposal selection against pseudo ground truth
        (rpn.forward_teacher -> box_selector_train, rpn.py:146-177)."""
        c = self.config
        objectness, box_reg = self.rpn(features)
        return select_proposals(
            objectness, box_reg, self.anchors, image_sizes,
            pre_nms_top_n=c.pre_nms_top_n_train, post_nms_top_n=c.post_nms_top_n_train,
            fpn_post_nms_top_n=c.fpn_post_nms_top_n_train, nms_thresh=c.rpn_nms_thresh,
            min_size=c.rpn_min_size, is_train=True, gt=pseudo_gt,
        )

    def detections_from_features(self, features, image_sizes, images=None) -> Detections:
        """Test-mode detections from a computed feature pyramid (the MT
        teacher reuses its view-0 pyramid). ``images`` feed the PRCNN mask
        head only."""
        # the record_function labels name the stages in a torch.profiler trace
        # (scripts/profile_torch_port.py); they do nothing when no profiler runs
        c = self.config
        with record_function("rpn_head"):
            objectness, box_reg = self.rpn(features)
        with record_function("rpn_select_proposals"):
            proposals = select_proposals(
                objectness, box_reg, self.anchors, image_sizes,
                pre_nms_top_n=c.pre_nms_top_n_test,
                post_nms_top_n=c.post_nms_top_n_test,
                fpn_post_nms_top_n=c.fpn_post_nms_top_n_test,
                nms_thresh=c.rpn_nms_thresh,
                min_size=c.rpn_min_size,
            )
        if c.rpn_only:
            # the proposals are the detections, by decreasing objectness
            key = torch.where(proposals.valid, proposals.scores, -torch.inf)
            order = torch.argsort(-key, dim=1, stable=True)
            valid = torch.gather(proposals.valid, 1, order)
            return Detections(
                boxes=torch.gather(proposals.boxes, 1, order[..., None].expand(-1, -1, 4)),
                scores=torch.where(valid, torch.gather(proposals.scores, 1, order), 0.0),
                labels=valid.to(torch.int32),
                valid=valid,
            )
        with record_function("box_head"):
            class_logits, box_regression, box_feats = self.box_forward(features, proposals.boxes)
        if c.with_relation_nms:
            with record_function("relation_nms"):
                probs = torch.softmax(class_logits.float(), dim=-1)
                out = self.relation_nms(box_feats, probs, box_regression, proposals.boxes, proposals.valid,
                                        image_sizes)
                boxes, scores, labels, valid = relation_nms_inference(out, c.relation)
            dets = Detections(boxes=boxes, scores=scores, labels=labels, valid=valid)
        else:
            with record_function("box_postprocess"):
                dets = postprocess_boxes(
                    class_logits, box_regression, proposals, image_sizes, num_classes=c.num_classes,
                    score_thresh=c.score_thresh, nms_thresh=c.nms_thresh,
                    detections_per_img=c.detections_per_img, reg_weights=c.reg_weights, nms_type=c.nms_type,
                )
        if c.mask_on:
            with record_function("mask_head"):
                mask_logits, mask_feats = self.mask_forward(features, dets.boxes, images)
            with record_function("mask_relation_ciam"):
                if c.with_relation_mask:
                    mask_logits = self.refine_masks(mask_logits, mask_feats, dets.labels, dets.valid)
                dets.masks = select_mask_probs(mask_logits, dets.labels)
        return dets


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def load_config(config_path: str | None = FLAGSHIP_CONFIG, opts=()):
    """The config tree of a YAML file (None: the defaults alone) plus yacs
    ``KEY VALUE`` overrides."""
    cfg = get_cfg()
    if config_path is not None:
        cfg.merge_from_file(config_path)
    cfg.merge_from_list(list(opts))
    return cfg


def model_from_cfg(cfg, device, seed: int = 0, train: bool = False) -> MaskRCNN:
    """The model of ``cfg`` with random weights made from ``seed``, in eval
    mode; ``train`` builds the training graph (the MGD hint adaptor)."""
    model = MaskRCNN(ModelConfig.from_cfg(cfg, train=train))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device)


def build_model(config_path: str = FLAGSHIP_CONFIG, device=None, seed: int = 0, opts=()) -> MaskRCNN:
    """The flagship model from a YAML config (plus yacs ``KEY VALUE`` overrides
    in ``opts``) with random weights made from ``seed``, in eval mode."""
    dev = resolve_device(device)
    return model_from_cfg(load_config(config_path, opts), dev, seed)
