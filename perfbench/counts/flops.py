"""Model FLOPs of a configuration's test-time forward, from its shapes.

Counted stage by stage as ``torch.utils.flop_counter.FlopCounterMode``
counts them (2 per multiply-add) over the convolutions, linear layers and
products of the reference: a convolution 2 x output positions x output
channels x input channels a group x kernel area (a transposed one over its
input positions), a product of [m, k] and [k, n] 2mkn. Element-wise work,
sorting, NMS and ROIAlign are not model FLOPs. The RoI counts are the
configuration's fixed, padded ones, so the count does not depend on the
data or on how the program runs.
"""

from __future__ import annotations


def _conv(n, hw_out, c_out, c_in, k):
    return 2 * n * hw_out * c_out * c_in * k * k


def _out(s: int, stride: int) -> int:
    return -(-s // stride)


def resnet_fpn(model: dict, batch: int, frozen_inputs: bool = False) -> dict:
    """The R-50 body (stem, layer1..layer4, stride in the 1x1) and the FPN;
    ``frozen_inputs``: instead, the FLOPs of the convolutions whose input
    is the frozen layer1's output (no input gradient in the backward)."""
    s = model["image_size"]
    blocks = {"R-50-FPN": (3, 4, 6, 3), "R-101-FPN": (3, 4, 23, 3)}[model["conv_body"]]
    h = _out(s, 2)
    body = _conv(batch, h * h, 64, 3, 7)
    h = _out(h, 2)  # max pool
    in_ch, level_hw, level_ch = 64, [], []
    trainable = frozen_in = 0
    for i, n_blocks in enumerate(blocks):
        bott, out = 64 * 2**i, 256 * 2**i
        for b in range(n_blocks):
            stride = (1 if i == 0 else 2) if b == 0 else 1
            ho = _out(h, stride)
            block = first = 0
            if in_ch != out:
                first += _conv(batch, ho * ho, out, in_ch, 1)
            first += _conv(batch, ho * ho, bott, in_ch, 1)  # conv1, stride here
            block += _conv(batch, ho * ho, bott, bott, 3)
            block += _conv(batch, ho * ho, out, bott, 1)
            body += first + block
            if i >= 1:
                trainable += first + block
                if b == 0 and i == 1:
                    frozen_in += first
            in_ch, h = out, ho
        level_hw.append(h * h)
        level_ch.append(out)
    c = model["backbone_out_channels"]
    inner = [_conv(batch, hw, c, ci, 1) for hw, ci in zip(level_hw, level_ch)]
    fpn = sum(inner) + sum(_conv(batch, hw, c, c, 3) for hw in level_hw)
    if frozen_inputs:
        return {"backbone": frozen_in + inner[0], "trainable": trainable + fpn}
    return {"backbone": body + fpn}


def rpn_head(model: dict, batch: int) -> int:
    c, a = model["backbone_out_channels"], len(model["aspect_ratios"])
    s = model["image_size"]
    total = 0
    for stride in model["anchor_strides"]:
        h = _out(s, stride)
        total += _conv(batch, h * h, c, c, 3) + _conv(batch, h * h, a, c, 1) + _conv(batch, h * h, 4 * a, c, 1)
    return total


def box_head(model: dict, batch: int, rois: int) -> int:
    p, c, d, k = model["box_pooler_resolution"], model["backbone_out_channels"], model["mlp_dim"], model["num_classes"]
    return 2 * batch * rois * (c * p * p * d + d * d + d * k + d * 4 * k)


def relation_nms(model: dict, batch: int, rois: int) -> int:
    r = model["relation"]
    n, cf = min(r["first_n"], rois), r["num_classes"] - 1
    f, a, g, geo = r["roi_feat_dim"], r["appearance_dim"], r["group"], r["geo_dim"]
    d0, d1, d2 = r["hid_dim"]
    total = 2 * batch * rois * f * a  # roi_feat_embedding_fc over every proposal
    total += 2 * n * f * a  # nms_rank_fc over the rank embedding, once a forward
    m = batch * cf  # attention problems
    total += 2 * m * n * n * geo * g  # WG
    total += 2 * m * n * a * (d0 + d1)  # WQ, WK
    total += 2 * m * g * n * n * (d1 // g)  # affinities
    total += 2 * m * g * n * n * a  # attention x appearance
    total += 2 * m * n * d2 * (g * a // g)  # grouped 1x1 output conv
    total += 2 * m * n * a * len(r["threshs"])  # classifier
    return total


def mask_head(model: dict, batch: int, dets: int) -> int:
    p, c, k = model["mask_pooler_resolution"], model["backbone_out_channels"], model["num_classes"]
    n = batch * dets
    total = 4 * _conv(n, p * p, 256, c, 3)
    total += _conv(n, p * p, 256, 256, 2)  # the 2x2 stride-2 transposed conv, over its input
    total += _conv(n, 4 * p * p, k, 256, 1)
    return total


def mask_relation_ciam(model: dict, batch: int, dets: int) -> int:
    rm = model["relation_mask"]
    p, c, e, k = model["mask_pooler_resolution"], model["backbone_out_channels"], rm["extractor_channel"], rm["num_classes"]
    n = batch * dets
    total = _conv(n, p * p, 256, c + 1, 3) + 2 * _conv(n, p * p, 256, 256, 3) + _conv(n, p * p, e, 256, 3)
    total += 2 * batch * e * dets * dets * p * p  # per-channel Gram
    total += 2 * batch * dets * dets * p * p * e  # attention x features
    total += _conv(n, p * p, e, e, 2) + _conv(n, 4 * p * p, k, e, 1)
    return total


def mask_rcnn_fpn(model: dict, batch: int) -> dict:
    """FLOPs by stage of one test-time forward of ``batch`` images."""
    rois = min(model["fpn_post_nms_top_n_test"], len(model["anchor_strides"]) * model["post_nms_top_n_test"])
    out = resnet_fpn(model, batch)
    out["rpn_head"] = rpn_head(model, batch)
    out["box_head"] = box_head(model, batch, rois)
    if model["with_relation_nms"]:
        r = model["relation"]
        per_class = min(r["detections_per_img"], min(r["first_n"], rois))
        dets = min(r["detections_per_img"], (r["num_classes"] - 1) * per_class)
        out["relation_nms"] = relation_nms(model, batch, rois)
    else:
        dets = model["detections_per_img"]
    if model["mask_on"]:
        out["mask_head"] = mask_head(model, batch, dets)
        if model["with_relation_mask"]:
            out["mask_relation_ciam"] = mask_relation_ciam(model, batch, dets)
    return out


def mask_rcnn_fpn_train(model: dict, batch: int) -> dict:
    """FLOPs by stage of one supervised training step of ``batch`` images:
    the forward on the sampled RoIs, then the backward, which costs twice
    the forward of every layer that trains (input and weight gradients)
    except the input gradients that nothing needs: none for the frozen
    stem and layer1, none into layer1's output. The gt masks are at the
    canvas's resolution, as the training loaders pad them."""
    if model["with_relation_nms"] or model["with_relation_mask"]:
        raise ValueError("the training count covers the plain Mask R-CNN only")
    rois, pos = model["box_batch_per_image"], model["mask_max_pos"]
    fwd = resnet_fpn(model, batch)
    fwd["rpn_head"] = rpn_head(model, batch)
    fwd["box_head"] = box_head(model, batch, rois)
    fwd["mask_head"] = mask_head(model, batch, pos)
    # each positive's gt mask (full canvas) cropped to its box, rows then columns
    r, hm = 2 * model["mask_pooler_resolution"], model["image_size"]
    fwd["mask_targets"] = batch * pos * (2 * r * hm * hm + 2 * r * hm * r)
    bb = resnet_fpn(model, batch, frozen_inputs=True)
    heads = fwd["rpn_head"] + fwd["box_head"] + fwd["mask_head"]
    out = {f"{k}_forward": v for k, v in fwd.items()}
    out["backward"] = 2 * (bb["trainable"] + heads) - bb["backbone"]
    return out


def _hint_adaptor(model: dict, batch: int, hint_dim: int = 128) -> int:
    s, c = model["image_size"], model["backbone_out_channels"]
    return sum(_conv(batch, _out(s, st) ** 2, hint_dim, c, 1) for st in model["anchor_strides"])


def _relation_backward(model: dict, batch: int, rois: int) -> int:
    """Relation-NMS's backward: twice its forward, but the rank embedding's
    layer takes no input gradient (its input is a constant)."""
    r = model["relation"]
    n = min(r["first_n"], rois)
    return 2 * relation_nms(model, batch, rois) - 2 * n * r["roi_feat_dim"] * r["appearance_dim"]


def mmt_psm_train(model: dict, batch: int) -> dict:
    """FLOPs by stage of one mean-teacher step of the flagship: ``batch``
    labeled images (the supervised forward with relation-NMS and CIAM on
    the sampled RoIs), ``batch`` unlabeled ones (the teacher's backbone and
    MGD adaptor over AUG_K views and their flips, its test-time detections
    and train-mode proposals on view 0, its box head over every view's
    sampled RoIs; the student's backbone, adaptor and box head over its one
    view), then the student's backward. AUG_K 2 and AUG_S 1, as the
    flagship's MT block sets them."""
    views, rois, pos = 4, model["box_batch_per_image"], model["mask_max_pos"]
    test_rois = min(model["fpn_post_nms_top_n_test"], len(model["anchor_strides"]) * model["post_nms_top_n_test"])
    r = model["relation"]
    dets = min(r["detections_per_img"], (r["num_classes"] - 1) * min(r["detections_per_img"], min(r["first_n"], test_rois)))
    bb = resnet_fpn(model, batch)["backbone"]
    bb_grad = resnet_fpn(model, batch, frozen_inputs=True)
    sup_heads = (rpn_head(model, batch) + box_head(model, batch, rois) + mask_head(model, batch, pos)
                 + mask_relation_ciam(model, batch, pos))
    hm, rr = model["image_size"], 2 * model["mask_pooler_resolution"]
    out = {
        "supervised_forward": bb + sup_heads + relation_nms(model, batch, rois)
        + batch * pos * (2 * rr * hm * hm + 2 * rr * hm * rr),
        "teacher_backbone": resnet_fpn(model, views * batch)["backbone"] + _hint_adaptor(model, views * batch),
        "teacher_pseudo_labels": rpn_head(model, batch) + box_head(model, batch, test_rois)
        + relation_nms(model, batch, test_rois) + mask_head(model, batch, dets) + mask_relation_ciam(model, batch, dets),
        "teacher_box_head": rpn_head(model, batch) + box_head(model, views * batch, rois),
        "student_forward": bb + _hint_adaptor(model, batch) + box_head(model, batch, rois),
    }
    # PSM reads the student's class logits only: its box deltas take no gradient
    d, k = model["mlp_dim"], model["num_classes"]
    unlabeled_grad = _hint_adaptor(model, batch) + box_head(model, batch, rois) - 2 * batch * rois * d * 4 * k
    out["backward"] = (2 * (2 * bb_grad["trainable"] + sup_heads + unlabeled_grad) - 2 * bb_grad["backbone"]
                       + _relation_backward(model, batch, rois))
    return out


COUNTS = {"mask_rcnn_fpn": mask_rcnn_fpn, "mask_rcnn_fpn_train": mask_rcnn_fpn_train, "mmt_psm_train": mmt_psm_train}
