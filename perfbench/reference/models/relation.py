"""IR-Net relation-NMS (port of ``mmt_psm_tpu/models/relation.py``).

The top FIRST_N proposals of each foreground class, boxes decoded per
class and clipped; a 128-d appearance embedding plus a sinusoidal rank
embedding; 16-group attention with a geometric gate
log(relu(WG(pos))) + qk/sqrt(d) and a top-K sparse softmax; a grouped
1x1 output conv; a per-threshold classifier. At test time the merged
scores go through per-class greedy NMS (0.5 for nuclei, POS_NMS for
cytoplasm) and a global cap; in training each gt's best-scoring box above
a threshold is the target, as 1 or, with REG_IOU, as its IoU (MSE loss,
else BCE on score x logit). Everything here runs in float32 and is
batched over images; all per-class NMS problems of the batch go to one
launch of kernel K1. No gradient is stopped: the head trains the box
head's features, scores and regression through it, and with REG_IOU
through its IoU targets too, as in the JAX graph.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import decode
from ..ops.nms import nms_topk
from ..ops.topk import top_k
from .. import comm
from ..structures.boxes import box_iou, clip_to_image
from .layers import Conv2d, Linear, variance_scaling_


@dataclasses.dataclass(frozen=True)
class RelationNMSConfig:
    first_n: int = 90
    threshs: tuple = (0.1,)
    roi_feat_dim: int = 1024
    appearance_dim: int = 128
    geo_dim: int = 64
    group: int = 16
    hid_dim: tuple = (1024, 1024, 128)
    topk: int = 40
    reg_iou: bool = True
    fg_thread: float = 0.1
    merge_method: int = 0
    pos_nms: float = 0.55
    nms_thresh: float = 0.5
    detections_per_img: int = 200
    num_classes: int = 3
    reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)

    @classmethod
    def from_cfg(cls, cfg):
        r = cfg.MODEL.RELATION_NMS
        return cls(
            first_n=r.FIRST_N,
            threshs=tuple(r.THREAD),
            roi_feat_dim=r.ROI_FEAT_DIM,
            appearance_dim=r.APPEARANCE_FEAT_DIM,
            geo_dim=r.GEO_FEAT_DIM,
            group=r.GROUP,
            hid_dim=tuple(r.HID_DIM),
            topk=r.TOPK,
            reg_iou=r.REG_IOU,
            fg_thread=r.FG_THREAD,
            merge_method=r.MERGE_METHOD,
            pos_nms=r.POS_NMS,
            detections_per_img=cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
        )


def rank_embedding(rank_dim: int, feat_dim: int, device, wave_length: float = 1000.0):
    """Sinusoidal rank embedding [rank_dim, feat_dim]."""
    rank = torch.arange(rank_dim, dtype=torch.float32, device=device)[:, None]
    feat = torch.arange(feat_dim // 2, dtype=torch.float32, device=device)
    dim_mat = 1.0 / torch.pow(wave_length, feat / (feat_dim / 2))
    mul = rank * dim_mat[None, :]
    return torch.cat([torch.sin(mul), torch.cos(mul)], dim=-1)


def position_matrix_embedding(boxes, dim_g: int, wave_len: float = 1000.0):
    """Pairwise geometric embedding [B, C, N, N, dim_g] of boxes [B, N, C, 4]."""
    b = boxes.permute(0, 2, 1, 3)  # [B, C, N, 4]
    x_min, y_min, x_max, y_max = b.split(1, dim=-1)  # [B, C, N, 1]
    cx = (x_min + x_max) * 0.5
    cy = (y_min + y_max) * 0.5
    w = (x_max - x_min) + 1.0
    h = (y_max - y_min) + 1.0

    def rel(delta, denom):
        return torch.log(torch.abs(delta / denom).clamp(min=1e-3))

    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    delta_x = rel(cx - t(cx), w)
    delta_y = rel(cy - t(cy), h)
    delta_w = torch.log(w / t(w))
    delta_h = torch.log(h / t(h))
    pos = torch.stack([delta_x, delta_y, delta_w, delta_h], dim=-1)  # [B, C, N, N, 4]

    dev = 8
    feat = torch.arange(dim_g // dev, dtype=torch.float32, device=boxes.device)
    dim_mat = 1.0 / torch.pow(wave_len, feat / (dim_g / dev))
    mul = 100.0 * pos[..., None] * dim_mat  # [B, C, N, N, 4, dim_g/8]
    mul = mul.reshape(*pos.shape[:4], -1)
    return torch.cat([torch.sin(mul), torch.cos(mul)], dim=-1)


class RelationAttention(nn.Module):
    """Multi-head attention over the sorted proposals of each class."""

    def __init__(self, appearance_dim=128, geo_dim=64, group=16, dim=(1024, 1024, 128), topk=40):
        super().__init__()
        self.group, self.dim, self.topk = group, dim, topk
        self.WG = Linear(geo_dim, group)
        self.WK = Linear(appearance_dim, dim[1])
        self.WQ = Linear(appearance_dim, dim[0])
        self.conv1 = Conv2d(group * appearance_dim, dim[2], 1, groups=group)

    def forward(self, f_a, pos_emb, valid):
        """f_a [B, N, C, D]; pos_emb [B, C, N, N, geo]; valid [B, N, C] -> [B, N, C, dim2]."""
        bsz, n, c, d = f_a.shape
        g = self.group
        dg0, dg1 = self.dim[0] // g, self.dim[1] // g
        w_g = F.relu(self.WG(pos_emb))  # [B, C, N, N, G]
        fa_c = f_a.permute(0, 2, 1, 3)  # [B, C, N, D]
        w_k = self.WK(fa_c).reshape(bsz, c, n, g, dg1)
        w_q = self.WQ(fa_c).reshape(bsz, c, n, g, dg0)
        aff = torch.einsum("bcngd,bcmgd->bcgnm", w_q, w_k) / math.sqrt(float(dg1))
        w_mn = torch.log(w_g.permute(0, 1, 4, 2, 3).clamp(min=1e-6)) + aff  # [B, C, G, N, N]
        key_valid = valid.permute(0, 2, 1)[:, :, None, None, :]
        w_mn = torch.where(key_valid, w_mn, -1e30)

        top_vals, top_idx = top_k(w_mn, min(n, self.topk))
        attn = torch.zeros_like(w_mn).scatter(-1, top_idx, torch.softmax(top_vals, dim=-1))
        out = torch.einsum("bcgnm,bcmd->bcgnd", attn, fa_c)  # [B, C, G, N, D]
        out = out.permute(0, 3, 1, 2, 4).reshape(bsz, n, c, g * d)  # channel = g*D + d
        out = self.conv1(out.permute(0, 3, 1, 2))  # [B, dim2, N, C]
        return out.permute(0, 2, 3, 1)


class RelationNMS(nn.Module):
    """Learned NMS head, batched over images."""

    def __init__(self, config: RelationNMSConfig):
        super().__init__()
        c = self.config = config
        self.roi_feat_embedding_fc = Linear(c.roi_feat_dim, c.appearance_dim)
        self.nms_rank_fc = Linear(c.roi_feat_dim, c.appearance_dim)
        self.relation_module = RelationAttention(
            c.appearance_dim, c.geo_dim, c.group, (c.hid_dim[0], c.hid_dim[1], c.appearance_dim), c.topk
        )
        self.classifier = Linear(c.appearance_dim, len(c.threshs))

    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d)):
                variance_scaling_(m.weight, 1.0, "fan_in", "truncated_normal", gen)  # flax lecun_normal
                nn.init.zeros_(m.bias)

    def forward(self, appearance, probs, box_regression, prop_boxes, prop_valid, image_sizes):
        """appearance [B, S, F] (fc7); probs [B, S, C] softmaxed; box_regression
        [B, S, 4C]; prop_boxes [B, S, 4]; prop_valid [B, S]; image_sizes [B, 2]."""
        c = self.config
        bsz, s = prop_valid.shape
        cf = c.num_classes - 1
        decoded = decode(box_regression.float(), prop_boxes, c.reg_weights).reshape(bsz, s, c.num_classes, 4)

        fg_scores = torch.where(prop_valid[..., None], probs[..., 1:], -1.0)  # [B, S, C-1]
        n = min(c.first_n, s)
        sorted_scores, idx = top_k(fg_scores.transpose(1, 2), n)
        sorted_scores = sorted_scores.transpose(1, 2)  # [B, N, C-1]
        idx = idx.transpose(1, 2)
        sorted_valid = sorted_scores > -0.5

        sorted_boxes = torch.gather(decoded[:, :, 1:, :], 1, idx[..., None].expand(-1, -1, -1, 4))
        sorted_boxes = clip_to_image(sorted_boxes, image_sizes[:, 0, None, None], image_sizes[:, 1, None, None])

        feat = self.roi_feat_embedding_fc(appearance.float())  # [B, S, D]
        d = feat.shape[-1]
        sorted_feat = torch.gather(feat[:, :, None, :].expand(-1, -1, cf, -1), 1, idx[..., None].expand(-1, -1, -1, d))
        rank = self.nms_rank_fc(rank_embedding(n, c.roi_feat_dim, feat.device))  # [N, D]
        sorted_feat = sorted_feat + rank[None, :, None, :]

        pos_emb = position_matrix_embedding(sorted_boxes, c.geo_dim)
        attn = self.relation_module(sorted_feat, pos_emb, sorted_valid)
        logits = self.classifier(F.relu(sorted_feat + attn))  # [B, N, C-1, T]
        if not c.reg_iou:
            logits = torch.sigmoid(logits)
        return {
            "logits": logits,
            "sorted_boxes": sorted_boxes,
            "sorted_scores": sorted_scores,
            "sorted_valid": sorted_valid,
            "sorted_idx": idx,
        }


def prepare_nms_labels(sorted_boxes, sorted_scores, gt_boxes, gt_labels, gt_valid, threshs, reg_iou: bool):
    """Per-class training targets [B, N, C-1, T]: for each gt of the class
    and each threshold, the highest-scoring box whose best-IoU gt it is,
    with IoU above the threshold, gets 1 (its IoU with REG_IOU).

    sorted_boxes [B, N, C-1, 4]; sorted_scores [B, N, C-1]; gt [B, M, ...].
    Differentiable in the boxes where ``reg_iou`` (the JAX graph's IoU
    targets carry gradient)."""
    bsz, n, c_fg = sorted_scores.shape
    m = gt_boxes.shape[1]
    outs = []
    for ci in range(c_fg):
        boxes = sorted_boxes[:, :, ci, :]
        score = sorted_scores[:, :, ci]
        is_cls = gt_valid & (gt_labels == ci + 1)  # [B, M]
        iou = torch.where(is_cls[:, None, :], box_iou(boxes, gt_boxes), 0.0)  # [B, N, M]
        eye = F.one_hot(iou.argmax(-1), m).to(iou.dtype)  # each box's best gt
        has_gt = is_cls.any(-1, keepdim=True).to(iou.dtype)  # [B, 1]
        per_t = []
        for t in threshs:
            overlap = (iou > t) & is_cls[:, None, :]
            overlap_score = score[:, :, None] * overlap * eye
            max_score_dt = overlap_score.argmax(1)  # [B, M]
            valid_dt = overlap.any(-1)  # [B, N]
            hits = torch.zeros(bsz, n, dtype=torch.long, device=iou.device).scatter_add(1, max_score_dt,
                                                                                          is_cls.long())
            chosen = (hits > 0) & valid_dt
            if reg_iou:
                overlap_iou = iou * overlap * eye
                val_per_gt = torch.gather(overlap_iou, 1, max_score_dt[:, None, :])[:, 0, :]  # [B, M]
                vals = torch.zeros(bsz, n, dtype=iou.dtype, device=iou.device).scatter_reduce(
                    1, max_score_dt, torch.where(is_cls, val_per_gt, 0.0), "amax")
                per_t.append(torch.where(chosen, vals, 0.0) * has_gt)
            else:
                per_t.append(chosen.to(iou.dtype) * has_gt)
        outs.append(torch.stack(per_t, -1))  # [B, N, T]
    return torch.stack(outs, 2)


def relation_nms_loss(out, gt_boxes, gt_labels, gt_valid, cfg: RelationNMSConfig):
    """The mean over the global batch's images of each image's relation-NMS loss."""
    labels = prepare_nms_labels(out["sorted_boxes"], out["sorted_scores"], gt_boxes, gt_labels, gt_valid,
                                cfg.threshs, cfg.reg_iou)
    valid = out["sorted_valid"][..., None].float()
    if cfg.reg_iou:
        per_item = (labels - out["logits"]) ** 2
    else:
        p = (out["sorted_scores"][..., None] * out["logits"]).clamp(1e-6, 1 - 1e-6)
        per_item = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    per_image = (per_item * valid).sum((1, 2, 3)) / valid.sum((1, 2, 3)).clamp(min=1.0)
    return comm.batch_mean(per_image)


def relation_nms_inference(out, cfg: RelationNMSConfig):
    """Test-time duplicate removal, batched: (boxes [B,K,4], scores [B,K],
    labels int32 [B,K], valid [B,K])."""
    logits = out["logits"]
    scores_in = out["sorted_scores"][..., None] * torch.ones_like(logits)
    if cfg.reg_iou:
        scores = logits * (scores_in > cfg.fg_thread)
    else:
        scores = logits * scores_in
    if cfg.merge_method == -1:
        merged = scores.mean(-1)
    elif cfg.merge_method == -2:
        merged = scores.amax(-1)
    else:
        merged = scores[..., min(max(cfg.merge_method, 0), len(cfg.threshs) - 1)]  # [B, N, C-1]

    bsz, n, cf = merged.shape
    k_cap = cfg.detections_per_img
    boxes_c = [out["sorted_boxes"][:, :, ci, :] for ci in range(cf)]
    scores_c = [merged[:, :, ci] for ci in range(cf)]
    valid_c = [out["sorted_valid"][:, :, ci] & (scores_c[ci] >= cfg.fg_thread) for ci in range(cf)]
    # nuclei (label 2) always NMS 0.5; cytoplasm (label 1) POS_NMS if > 0
    thresh = [cfg.nms_thresh if ci == 1 else (cfg.pos_nms if cfg.pos_nms > 0 else None) for ci in range(cf)]
    nms_cls = [ci for ci in range(cf) if thresh[ci] is not None]
    kept = {}
    if nms_cls:
        thr = torch.cat([torch.full((bsz,), float(thresh[ci]), dtype=torch.float32, device=merged.device) for ci in nms_cls])
        kidx, kval = nms_topk(
            torch.cat([boxes_c[ci] for ci in nms_cls]),
            torch.cat([scores_c[ci] for ci in nms_cls]),
            torch.cat([valid_c[ci] for ci in nms_cls]),
            thr,
            min(k_cap, n),
        )
        for j, ci in enumerate(nms_cls):
            kept[ci] = (kidx[j * bsz:(j + 1) * bsz], kval[j * bsz:(j + 1) * bsz])

    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for ci in range(cf):
        b, s, v = boxes_c[ci], scores_c[ci], valid_c[ci]
        if ci in kept:
            kidx, kval = kept[ci]
            b = torch.gather(b, 1, kidx[..., None].expand(-1, -1, 4))
            s = torch.gather(s, 1, kidx)
            v = kval
        all_boxes.append(b)
        all_scores.append(torch.where(v, s, 0.0))
        all_labels.append(torch.full(v.shape, ci + 1, dtype=torch.int32, device=v.device))
        all_valid.append(v)
    boxes = torch.cat(all_boxes, 1)
    scores = torch.cat(all_scores, 1)
    labels = torch.cat(all_labels, 1)
    valid = torch.cat(all_valid, 1)

    top_scores, top_idx = top_k(torch.where(valid, scores, -1e30), min(k_cap, scores.shape[1]))
    keep = top_scores > -1e29
    return (
        torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)),
        torch.where(keep, top_scores, 0.0),
        torch.where(keep, torch.gather(labels, 1, top_idx), 0),
        keep,
    )
