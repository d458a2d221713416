"""The mean-teacher MMT-PSM losses: PSM + MGD (port of
``mmt_psm_tpu/train/mt_step.py``).

The reference's unlabeled branch (maskrcnn_benchmark/engine/MTtrainer.py:
247-275 -> generalized_rcnn.forward_teacher:117-167 / forward_student:
170-199) as functions over the ``MaskRCNN`` sub-forwards:

* the teacher runs the backbone on each of K color-aug views and their
  horizontal flips, 2K pyramids in one batched pass (extract_aug_feat
  :201-215); its inference on view 0 gives the pseudo ground truth
  (:122-127), whose pasted masks sum into the MGD integral canvas
  (:129-131);
* box RoIs come from train-mode proposals and balanced subsampling
  against the pseudo ground truth, shared across views; flipped views take
  flipped RoIs (box_head.py:77-100);
* PSM (box_head/loss.py:185-237): the teacher's per-view probabilities
  give a mean and a spread; hard negatives are the negatives of largest
  spread, kept at pos:neg = 2:1; the student's soft cross entropy against
  sharpen(softmax(mean raw logits), T), negatives weighted by
  CLS_BALANCE_WEIGHT, over the selected count and the reference's literal
  /3 (box_head/loss.py:281-286);
* MGD (generalized_rcnn.py:243-282): masked MSE between hint-adaptor
  embeddings, the teacher's flipped views flipped back, averaged over
  (teacher view x student view x level);
* loss weighting (MTtrainer.py:67-109): 'mt*' keys times lambda *
  ramp(step), with the reference passing rampup_length into the rampdown
  call (line 92), kept.

Flips act on the fixed padded canvas. The step itself (supervised +
unlabeled losses, one backward, clip, SGD, EMA) is
``train.mean_teacher.MTTrainer``. The ``record_function`` labels name the
stages in a torch.profiler trace (scripts/profile_torch_port.py --mt).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..models.box_head import subsample_proposals
from ..ops import sampler
from ..ops.paste import paste_integral
from ..ops.topk import top_k
from ..parallel import comm
from ..structures.boxes import hflip_boxes
from ..structures.detections import GroundTruth
from ..utils.ramp import F32, sigmoid_rampdown, sigmoid_rampup


@dataclasses.dataclass(frozen=True)
class MTConfig:
    lambda_: float = 5.0
    alpha: float = 0.99
    rampup_step: int = 250
    rampdown_step: int = 250
    start_mt: int = 1000
    max_iter: int = 7000
    aug_k: int = 2
    aug_s: int = 1
    temp: float = 0.5
    sharpen: bool = True
    rank_filter: float = 0.2
    hard_neg: bool = True
    cls_balance_weight: float = 1.5
    cls_loss_weight: float = 0.2
    fg_hint: float = 1.0
    nms_loss_weight: float = 1.0
    flip: bool = True
    mgd_canvas_stride: int = 4  # the integral mask at P2's resolution
    # the compared methods the reference keeps (MT.ODKD / MT.FFI)
    odkd: bool = False
    ffi: bool = False
    # pseudo-label training: the consistency batch carries real gt, which
    # the teacher uses instead of its own inference (generalized_rcnn.py:133-138)
    pltrain: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "MTConfig":
        return cls(
            lambda_=cfg.MT.LAMBDA,
            alpha=cfg.MT.ALPHA,
            rampup_step=cfg.MT.RAMPUP_STEP,
            rampdown_step=cfg.MT.RAMPDOWN_STEP,
            start_mt=cfg.MT.START_MT,
            max_iter=cfg.SOLVER.MAX_ITER,
            aug_k=cfg.MT.AUG_K,
            aug_s=cfg.MT.AUG_S,
            temp=cfg.MT.TEMP,
            sharpen=cfg.MT.SHARPEN,
            rank_filter=cfg.MT.RANK_FILTER,
            hard_neg=cfg.MT.HARD_NEG,
            cls_balance_weight=cfg.MT.CLS_BALANCE_WEIGHT,
            cls_loss_weight=cfg.MT.CLS_LOSS,
            fg_hint=cfg.MT.FG_HINT,
            nms_loss_weight=cfg.MODEL.RELATION_NMS.LOSS,
            flip=cfg.MT.FLIP,
            odkd=cfg.MT.ODKD,
            ffi=cfg.MT.FFI,
            pltrain=cfg.MT.PLTRAIN,
        )


def hflip_image(x):
    """Flip NHWC (or HWC) images along W."""
    return torch.flip(x, dims=(-2,))


def hflip_feature(f):
    """Flip an NHWC feature map along W (utils/miscellaneous batch_hfilp)."""
    return torch.flip(f, dims=(-2,))


def _pooled_mask(canvas, h: int):
    """canvas [B, Hc, Wc] averaged down to a level of height ``h`` and
    thresholded at 0.5 -> f32 [B, h, w, 1] (flax ``avg_pool``, VALID)."""
    c = canvas[:, None]
    factor = c.shape[2] // h
    if factor > 1:
        c = F.avg_pool2d(c, factor, factor)
    return (c > 0.5).float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------------- PSM
def psm_loss(student_logits_views, teacher_logits_views, labels, valid, mt: MTConfig, num_classes: int):
    """Proposal soft-matching classification consistency.

    student/teacher_logits_views: lists of [B, S, C]; labels/valid [B, S]
    from the subsampling against the pseudo gt. The selection runs over the
    flattened batch, as the reference's cat over images (box_head/loss.py:187):
    under data parallelism over the global batch, whose negatives' spreads
    every rank gathers to rank them. Ranks, counts and weights stay on the
    device."""
    c = num_classes
    t = torch.stack([x.reshape(-1, c).float() for x in teacher_logits_views]).detach()  # [Vt, N, C]
    labels_f = labels.reshape(-1)
    valid_f = valid.reshape(-1)

    probs = torch.softmax(t, dim=-1)
    std_probs = torch.std(probs, dim=0, correction=1)  # torch.std is unbiased in the reference
    mean_raw = t.mean(0)  # the PSM target logits (loss.py:165-166)
    sigma = std_probs.sum(-1)  # [N]

    pos = (labels_f > 0) & valid_f
    neg = (labels_f == 0) & valid_f
    n_pos = comm.global_sum(pos.sum())

    # hard negatives: the top n_pos // 2 by sigma among the negatives, through
    # the rank of a stable sort (ties by index, as jnp.argsort)
    neg_sigma = comm.gather_rows(torch.where(neg, sigma, -torch.inf))
    order = top_k(neg_sigma, neg_sigma.shape[0])[1]
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0], device=order.device))
    keep_neg = neg & (comm.rank_rows(rank) < n_pos // 2)

    sel = pos | keep_neg
    w = pos.float() + keep_neg.float() * (mt.cls_balance_weight if mt.hard_neg else 1.0)

    target = torch.softmax(mean_raw, dim=-1)
    if mt.sharpen:
        p = target ** (1.0 / mt.temp)
        target = p / p.sum(-1, keepdim=True)

    n_sel = comm.global_sum(sel.sum()).clamp(min=1)
    losses = []
    for s_logits in student_logits_views:
        logp = torch.log_softmax(s_logits.reshape(-1, c).float(), dim=-1)
        # reference: (-t * logp * w).mean(0).sum() / 3 over the selected rows
        per = -(target * logp).sum(-1) * w
        losses.append(per.sum() / (n_sel.float() * 3.0))
    return torch.stack(losses).mean()


# ---------------------------------------------------------------------- MGD
def mgd_loss(teacher_emb_views, student_emb_views, integral_canvas, mt: MTConfig):
    """Mask-guided foreground feature distillation (generalized_rcnn.py:243-282).

    teacher_emb_views: a list over 2K views of per-level [B, h, w, D]; odd
    views were computed on flipped images and are flipped back here.
    student_emb_views: a list over S views (odd ones flipped back too).
    integral_canvas: [B, Hc, Wc] pasted instance-mask counts at
    ``mgd_canvas_stride``."""
    masks = [_pooled_mask(integral_canvas, f.shape[1]) for f in teacher_emb_views[0]]
    # each level's mask area over the global batch
    areas = comm.global_sum(torch.stack([m.sum() for m in masks]))
    dists = []
    for vi, t_view in enumerate(teacher_emb_views):
        t_view = [(hflip_feature(f) if vi % 2 == 1 else f).detach().float() for f in t_view]
        for si, s_view in enumerate(student_emb_views):
            for s_f, t_f, m, area in zip(s_view, t_view, masks, areas):
                s_f = s_f.float()
                if si % 2 == 1:
                    s_f = hflip_feature(s_f)
                dists.append((((s_f - t_f) ** 2) * m).sum() / (area * s_f.shape[-1] + 1e-7))
    return torch.stack(dists).mean()


# -------------------------------------------------- compared methods
def odkd_loss(student_logits, teacher_logits, labels, valid, neg_weight: float = 1.5):
    """ODKD baseline: single-view soft cross entropy, negatives weighted
    1.5x (box_head/loss.py:239-255). student/teacher_logits [B, S, C]."""
    c = student_logits.shape[-1]
    s = student_logits.reshape(-1, c).float()
    t = teacher_logits.reshape(-1, c).float().detach()
    labels_f = labels.reshape(-1)
    valid_f = valid.reshape(-1).float()
    logp = torch.log_softmax(s, dim=-1)
    target = torch.softmax(t, dim=-1)
    w = torch.where(labels_f == 0, neg_weight, 1.0) * valid_f
    per = -target * logp * w[:, None]
    # reference: the elementwise mean over all (rows x classes)
    return per.sum() / (comm.global_sum(valid_f.sum()) * c).clamp(min=1.0)


def ffi_hint_loss(teacher_emb_view0, student_emb_view0, box_canvas):
    """FFI baseline: box-canvas-masked feature MSE between the view-0
    embeddings (generalized_rcnn.py:284-294). box_canvas [B, Hc, Wc]: 1
    inside any foreground box."""
    dists = []
    for s_f, t_f in zip(student_emb_view0, teacher_emb_view0):
        s_f = s_f.float()
        t_f = t_f.float().detach()
        m = _pooled_mask(box_canvas, s_f.shape[1])
        dists.append((((s_f - t_f) ** 2) * m).sum() / (comm.global_sum(m.sum()) * s_f.shape[-1]).clamp(min=1.0))
    return torch.stack(dists).mean()


def naive_hint_loss(teacher_emb_view0, student_emb_view0):
    """ODKD's naive hint: unmasked feature MSE (generalized_rcnn.py:296-302)."""
    dists = [comm.batch_mean((s_f.float() - t_f.float().detach()) ** 2)
             for s_f, t_f in zip(student_emb_view0, teacher_emb_view0)]
    return torch.stack(dists).mean()


def boxes_to_canvas(boxes, valid, canvas_size: int, stride: float):
    """Binary canvas, 1 inside any valid box (the FFI box region finder,
    rpn/inference.py:174-191). boxes [..., K, 4] image coordinates;
    valid [..., K] -> f32 [..., canvas, canvas]."""
    xs = (torch.arange(canvas_size, dtype=torch.float32, device=boxes.device) + 0.5) * stride - 0.5
    inside_x = (xs >= boxes[..., 0:1]) & (xs <= boxes[..., 2:3])  # [..., K, W]
    inside_y = (xs >= boxes[..., 1:2]) & (xs <= boxes[..., 3:4])  # [..., K, H]
    hit = torch.einsum("...kh,...kw->...hw", (inside_y & valid[..., None]).float(), inside_x.float())
    return (hit > 0).float()


# ------------------------------------------------------------ loss weighting
def mt_loss_weight(step: int, mt: MTConfig) -> np.float32:
    """weight(step) of MTtrainer.weight_sum_losses (MTtrainer.py:89-94), in
    float32 on the host: the step is the trainer's own counter."""
    step = F32(step)
    gap = step - F32(mt.start_mt)
    if F32(0.0) < gap < F32(mt.rampup_step):
        return F32(mt.lambda_) * sigmoid_rampup(gap, mt.rampup_step)
    if F32(mt.max_iter) - step < F32(mt.rampdown_step):
        # reference quirk: rampdown is called with rampup_length (line 92)
        return F32(mt.lambda_) * sigmoid_rampdown(F32(mt.max_iter) - step, mt.rampup_step)
    return F32(mt.lambda_)


def weight_sum_losses(loss_dict, step: int, mt: MTConfig) -> dict:
    """Gate the 'mt*' keys by the ramp weight and apply the balanced per-key
    weights (MTtrainer.py:96-109, 141-145)."""
    weight = float(mt_loss_weight(step, mt))
    balanced = {
        "mt_classifier": mt.cls_loss_weight,
        "nms_loss": mt.nms_loss_weight,
        "mt_fg_loss": mt.fg_hint,
    }
    out = {}
    for k, v in loss_dict.items():
        v = v.float()
        if "mt" in k:
            v = v * weight
        if k in balanced:
            v = v * balanced[k]
        out[k] = v
    return out


# ------------------------------------------------------------ unlabeled pass
def gt_integral_canvas(masks, valid, canvas_size: int):
    """Integral foreground canvas from full-frame gt bitmasks: per-image sum
    of the instance masks, nearest-resampled to the MGD canvas (the PLTRAIN
    branch's masks.decode path, generalized_rcnn.py:133-138).
    masks [B, M, Hm, Wm]; valid [B, M]."""
    m = (masks > 0).float() * valid[:, :, None, None].float()
    integral = m.sum(1)  # [B, Hm, Wm]
    step = integral.shape[1] // canvas_size
    if step > 1:
        integral = integral[:, ::step, ::step]
    return integral[:, :canvas_size, :canvas_size]


def _views(tensors, n: int, bsz: int):
    """Split each stacked [n * B, ...] tensor into n per-view batch slices."""
    return [[x[v * bsz:(v + 1) * bsz] for x in tensors] for v in range(n)]


def unlabeled_losses(student, teacher, batch, gen: torch.Generator, mt: MTConfig, targets=None) -> dict:
    """Teacher pseudo-labelling and the student's consistency losses for one
    unlabeled K-aug batch.

    student, teacher: ``MaskRCNN`` models (the teacher in eval mode);
    batch: {"t_images": [B, K, H, W, 3], "s_images": [B, S, H, W, 3],
    "image_size": [B, 2]} on the device; ``gen`` draws the teacher RoIs'
    sampling and the student's dropout. targets: an optional
    ``GroundTruth`` with masks, the PLTRAIN branch (generalized_rcnn.py:
    133-138): the teacher skips its own inference and takes these labels.
    Returns ``mt_classifier`` (PSM), ``mt_fg_loss`` (MGD) and, for ODKD/FFI,
    ``mt_hint_loss``; nothing here waits on the card."""
    c = student.config
    t_images, s_images, sizes = batch["t_images"], batch["s_images"], batch["image_size"]
    dev = t_images.device
    use_mgd = mt.fg_hint > 0 and c.with_hint_adaptor
    use_psm = mt.cls_loss_weight > 0
    canvas_size = c.image_size // mt.mgd_canvas_stride
    bsz = t_images.shape[0]
    n_views = 2 * mt.aug_k

    # ---- teacher (no gradient) -----------------------------------------
    with torch.no_grad(), record_function("mt_teacher"):
        with record_function("mt_teacher_backbone"):
            # the 2K views, each aug view and its flip, as one [2K*B] batch;
            # the pseudo-labelling below reuses view 0's pyramid
            view_imgs = []
            for k in range(mt.aug_k):
                view_imgs += [t_images[:, k], hflip_image(t_images[:, k])]
            feats_all = teacher.backbone_features(torch.cat(view_imgs))
            t_feats = _views(feats_all, n_views, bsz)
        if targets is not None:
            pseudo = GroundTruth(boxes=targets.boxes, labels=targets.labels, valid=targets.valid)
            integral = gt_integral_canvas(targets.masks, targets.valid, canvas_size) if use_mgd else None
        else:
            with record_function("mt_teacher_pseudo_labels"):
                dets = teacher.detections_from_features(t_feats[0], sizes, t_images[:, 0])
            pseudo = GroundTruth(boxes=dets.boxes, labels=dets.labels, valid=dets.valid)
            integral = None
            if use_mgd:
                with record_function("mt_paste_integral"):
                    integral = paste_integral(dets.masks, dets.boxes, dets.valid, canvas_size,
                                              float(mt.mgd_canvas_stride))
        t_embs = None
        if use_mgd:
            with record_function("mt_hint_adaptor"):
                t_embs = _views(teacher.hint_embeddings(feats_all), n_views, bsz)

        with record_function("mt_teacher_box_head"):
            # proposals from view 0 against the pseudo gt, then subsampled
            proposals = teacher.teacher_proposals(t_feats[0], sizes, pseudo)
            rois = subsample_proposals(
                sampler.uniform(gen, proposals.valid.shape, dev), proposals, pseudo,
                batch_size_per_image=c.box_batch_per_image, positive_fraction=c.box_positive_fraction,
                fg_thresh=c.box_fg_iou, bg_thresh=c.box_bg_iou, reg_weights=c.reg_weights,
            )
            rois_boxes = rois.boxes
            flipped_boxes = hflip_boxes(rois_boxes, c.image_size)
            t_logits = []
            if use_psm:
                # one box-head pass (one K2 launch) over all 2K views: the
                # features and the flip-matched RoIs stack on the batch axis
                boxes_all = torch.cat([flipped_boxes if v % 2 == 1 else rois_boxes for v in range(n_views)])
                logits_all = teacher.box_predictions(feats_all, boxes_all, True)[0]
                t_logits = [logits_all[v * bsz:(v + 1) * bsz] for v in range(n_views)]

    # ---- student (gradient) ----------------------------------------------
    with record_function("mt_student"):
        n_s = s_images.shape[1]
        with record_function("mt_student_backbone"):
            s_view_imgs = [hflip_image(s_images[:, si]) if si % 2 == 1 else s_images[:, si] for si in range(n_s)]
            s_feats_all = student.backbone_features(torch.cat(s_view_imgs))
            s_feats = _views(s_feats_all, n_s, bsz)
        s_embs, s_logits = [], []
        if use_mgd:
            with record_function("mt_hint_adaptor"):
                s_embs = _views(student.hint_embeddings(s_feats_all), n_s, bsz)

        losses = {}
        if use_psm:
            with record_function("mt_psm"):
                s_boxes_all = torch.cat([flipped_boxes if si % 2 == 1 else rois_boxes for si in range(n_s)])
                s_logits_all = student.box_predictions(s_feats_all, s_boxes_all, False, gen, views=n_s)[0]
                s_logits = [s_logits_all[si * bsz:(si + 1) * bsz] for si in range(n_s)]
                if mt.odkd:
                    # ODKD takes precedence over PSM (generalized_rcnn.py:193-196,
                    # box_head.py:104-110): single-view soft distillation
                    losses["mt_classifier"] = odkd_loss(s_logits[0], t_logits[0], rois.labels, rois.valid,
                                                        mt.cls_balance_weight)
                else:
                    losses["mt_classifier"] = psm_loss(s_logits, t_logits, rois.labels, rois.valid, mt, c.num_classes)
        if use_mgd:
            with record_function("mt_mgd"):
                losses["mt_fg_loss"] = mgd_loss(t_embs, s_embs, integral, mt)
        if (mt.ffi or mt.odkd) and c.with_hint_adaptor:
            with torch.no_grad():
                t_emb0 = teacher.hint_embeddings(t_feats[0])
            s_emb0 = student.hint_embeddings(s_feats[0])
            if mt.ffi:
                canvas = boxes_to_canvas(pseudo.boxes, pseudo.valid, canvas_size, float(mt.mgd_canvas_stride))
                losses["mt_hint_loss"] = ffi_hint_loss(t_emb0, s_emb0, canvas)
            else:
                losses["mt_hint_loss"] = naive_hint_loss(t_emb0, s_emb0)
    return losses
