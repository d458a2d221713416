"""Mask R-CNN R-50-FPN with IR-Net relation-NMS and CIAM.

Port of ``mmt_psm_tpu/models/detector.py`` (``ModelConfig``,
``MaskRCNN.forward_test``, ``detections_from_features`` and
``forward_train``, and the mean teacher's sub-forwards and ``HintAdaptor``):
backbone -> RPN -> box head -> relation-NMS -> mask head -> mask relation,
all on padded fixed shapes with no host sync; at test time per-label mask
probabilities, in training the loss dict.
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
from .backbone import ResNetFPNBackbone
from .box_head import BoxHead, box_head_loss, subsample_proposals
from .layers import Conv2d, variance_scaling_
from .mask_head import (MaskRCNNC4Predictor, MaskRCNNFPNExtractor, crop_masks_to_boxes, kaiming_init,
                        mask_head_loss, select_mask_probs, select_positive_rois)
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
    mask_on: bool = True
    mask_pooler_resolution: int = 14
    mask_pooler_sampling: int = 2
    mask_max_pos: int = 128
    conv_body: str = "R-50-FPN"
    backbone_out_channels: int = 256
    freeze_at: int = 2
    compute_dtype: str = "bfloat16"
    # mean-teacher hint adaptor (MGD): a 1x1 conv per FPN level (MT.T_ADAPT)
    with_hint_adaptor: bool = False
    hint_dim: int = 128
    relation: Any = RelationNMSConfig()
    with_relation_mask: bool = True
    relation_mask: Any = MaskRelationConfig()

    @classmethod
    def from_cfg(cls, cfg, train: bool = False) -> "ModelConfig":
        """The graph ``cfg`` asks for; ``train`` adds the MGD hint adaptor
        where MT.FG_HINT > 0, as the JAX ``from_cfg(cfg, train=True)`` does
        (inference builds none)."""
        m = cfg.MODEL
        unsupported = {
            "MODEL.RPN_ONLY": m.RPN_ONLY,
            "MODEL.BACKBONE.CONV_BODY": not m.BACKBONE.CONV_BODY.endswith("-FPN"),
            "MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR": m.ROI_BOX_HEAD.FEATURE_EXTRACTOR != "FPN2MLPFeatureExtractor",
            "MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR": m.MASK_ON
            and m.ROI_MASK_HEAD.FEATURE_EXTRACTOR != "MaskRCNNFPNFeatureExtractor",
            # the box post-processor without relation-NMS is not ported yet
            "MODEL.RELATION_NMS.USE_RELATION_NMS": not m.RELATION_NMS.USE_RELATION_NMS,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"the port does not run these settings yet: {bad}")
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
            mask_on=bool(m.MASK_ON),
            mask_pooler_resolution=m.ROI_MASK_HEAD.POOLER_RESOLUTION,
            mask_pooler_sampling=m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO or 2,
            conv_body=m.BACKBONE.CONV_BODY,
            backbone_out_channels=m.BACKBONE.OUT_CHANNELS,
            freeze_at=m.BACKBONE.FREEZE_CONV_BODY_AT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            relation=RelationNMSConfig.from_cfg(cfg),
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


class MaskRCNN(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        c = self.config = config
        ch = c.backbone_out_channels
        self.backbone = ResNetFPNBackbone(c.conv_body, ch, freeze_at=c.freeze_at)
        self.rpn = RPN(ch, len(c.aspect_ratios))
        self.roi_heads = nn.Module()
        self.roi_heads.box = BoxHead(ch, c.box_pooler_resolution, c.mlp_dim, c.num_classes, c.box_head_dropout)
        if c.mask_on:
            mask = nn.Module()
            mask.feature_extractor = MaskRCNNFPNExtractor(ch)
            mask.predictor = MaskRCNNC4Predictor(256, c.num_classes)
            if c.with_relation_mask:
                mask.mask_relation_module = MaskRelationRefineNet(c.relation_mask, 256)
            self.roi_heads.mask = mask
        self.relation_nms = RelationNMS(c.relation)
        if c.with_hint_adaptor:
            self.hint_adaptor = HintAdaptor(ch, c.hint_dim, len(c.anchor_strides))
        for i, a in enumerate(fpn_anchors(c.image_size, c.anchor_strides, c.anchor_sizes, c.aspect_ratios)):
            self.register_buffer(f"anchors_{i}", torch.from_numpy(a), persistent=False)
        self.eval()

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32

    def init_weights(self, gen: torch.Generator) -> "MaskRCNN":
        """Seeded random weights of the JAX initialisers' scales."""
        self.backbone.init_weights(gen)
        self.rpn.head.init_weights(gen)
        self.roi_heads.box.feature_extractor.init_weights(gen)
        self.roi_heads.box.predictor.init_weights(gen)
        if self.config.mask_on:
            mask = self.roi_heads.mask
            kaiming_init(mask.feature_extractor, gen)
            kaiming_init(mask.predictor, gen)
            if self.config.with_relation_mask:
                mask.mask_relation_module.init_weights(gen)
        self.relation_nms.init_weights(gen)
        if self.config.with_hint_adaptor:
            self.hint_adaptor.init_weights(gen)
        return self

    @property
    def anchors(self):
        return [getattr(self, f"anchors_{i}") for i in range(len(self.config.anchor_strides))]

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
        masks. Returns ``loss_objectness``, ``loss_rpn_box_reg``,
        ``loss_classifier``, ``loss_box_reg``, ``nms_loss`` and
        ``loss_mask``, scalar tensors; nothing here waits on the card."""
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
            loss_cls, loss_box = box_head_loss(class_logits, box_regression, rois)
        losses = {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_rpn_box,
                  "loss_classifier": loss_cls, "loss_box_reg": loss_box}
        with record_function("relation_nms"):
            probs = torch.softmax(class_logits.float(), dim=-1)
            out = self.relation_nms(box_feats, probs, box_regression, rois.boxes, rois.valid, image_sizes)
            losses["nms_loss"] = relation_nms_loss(out, gt.boxes, gt.labels, gt.valid, c.relation)
        if c.mask_on:
            with record_function("mask_head"):
                m_boxes, m_labels, m_gt_idx, m_valid = select_positive_rois(rois, c.mask_max_pos)
                mask_logits, mask_feats = self.mask_forward(features, m_boxes)
                scale = gt.masks.shape[-1] / c.image_size
                targets = crop_masks_to_boxes(gt.masks, m_gt_idx, m_boxes * scale, mask_logits.shape[2])
                loss_mask = mask_head_loss(mask_logits, targets, m_labels, m_valid)
            if c.with_relation_mask:
                with record_function("mask_relation_ciam"):
                    refined = self.roi_heads.mask.mask_relation_module(mask_feats, mask_logits, m_labels, m_valid)
                    loss_refined = mask_head_loss(refined, targets, m_labels, m_valid)
                # deep supervision 0.5 * (L1 + L2)
                loss_mask = 0.5 * (loss_mask + loss_refined) if c.relation_mask.deep_super else loss_refined
            losses["loss_mask"] = loss_mask
        return losses

    def forward_test(self, images, image_sizes) -> Detections:
        with record_function("backbone"):
            features = self.backbone_features(images)
        return self.detections_from_features(features, image_sizes)

    def box_forward(self, features, boxes, gen: torch.Generator | None = None):
        """-> (class logits [B, S, C], box deltas [B, S, 4C], fc7 features
        [B, S, mlp_dim]); ``gen`` draws the train-mode dropout masks."""
        c = self.config
        pooled = multilevel_roi_align(
            features[: len(c.pooler_scales)], boxes, c.pooler_scales, c.box_pooler_resolution, c.box_pooler_sampling
        )
        b, s = pooled.shape[:2]
        box = self.roi_heads.box
        feats = box.feature_extractor(pooled.reshape(b * s, *pooled.shape[2:]), gen)
        logits, regs = box.predictor(feats)
        return logits.reshape(b, s, -1), regs.reshape(b, s, -1), feats.reshape(b, s, -1)

    def mask_forward(self, features, boxes):
        """-> (logits [B, K, 2P, 2P, classes], features [B, K, P, P, 256])."""
        c = self.config
        pooled = multilevel_roi_align(
            features[: len(c.pooler_scales)], boxes, c.pooler_scales, c.mask_pooler_resolution, c.mask_pooler_sampling
        )
        b, s, p = pooled.shape[:3]
        mask = self.roi_heads.mask
        x = mask.feature_extractor(pooled.reshape(b * s, p, p, -1).permute(0, 3, 1, 2))
        logits = mask.predictor(x)
        r = logits.shape[-1]
        return (logits.permute(0, 2, 3, 1).reshape(b, s, r, r, -1),
                x.permute(0, 2, 3, 1).reshape(b, s, p, p, -1))

    # -- sub-forwards of the mean-teacher step (JAX detector.py:366-406) --
    def backbone_features(self, images):
        """The feature pyramid P2..P6 of normalized NHWC images
        (extract_aug_feat's building block, generalized_rcnn.py:201-215)."""
        return self.backbone(images.to(self.compute_dtype))

    def hint_embeddings(self, features):
        """MGD embeddings of each level (generalized_rcnn.py:218-222)."""
        return self.hint_adaptor(features)

    def box_predictions(self, features, boxes, deterministic: bool = True, gen: torch.Generator | None = None):
        """Pool, box MLP and predictor on given per-image box sets
        (box_head.py:77-100): (class logits, box deltas, fc7 features).
        ``deterministic`` runs no dropout; else ``gen`` draws its masks.
        The JAX ``roi_chunk`` bounds a TPU temporary of its pooling
        contraction; kernel K2 has no such temporary, so the port pools
        every RoI of the stacked views in one launch."""
        return self.box_forward(features, boxes, None if deterministic else gen)

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

    def detections_from_features(self, features, image_sizes) -> Detections:
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
        with record_function("box_head"):
            class_logits, box_regression, box_feats = self.box_forward(features, proposals.boxes)
        with record_function("relation_nms"):
            probs = torch.softmax(class_logits.float(), dim=-1)
            out = self.relation_nms(box_feats, probs, box_regression, proposals.boxes, proposals.valid, image_sizes)
            boxes, scores, labels, valid = relation_nms_inference(out, c.relation)
        dets = Detections(boxes=boxes, scores=scores, labels=labels, valid=valid)
        if c.mask_on:
            with record_function("mask_head"):
                mask_logits, mask_feats = self.mask_forward(features, boxes)
            with record_function("mask_relation_ciam"):
                if c.with_relation_mask:
                    mask_logits = self.roi_heads.mask.mask_relation_module(mask_feats, mask_logits, labels, valid)
                dets.masks = select_mask_probs(mask_logits, labels)
        return dets


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def load_config(config_path: str = FLAGSHIP_CONFIG, opts=()):
    """The config tree of a YAML file plus yacs ``KEY VALUE`` overrides."""
    cfg = get_cfg()
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
