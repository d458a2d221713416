"""One mean-teacher step of the flagship (relation-NMS and CIAM)."""

from __future__ import annotations

from ..flops import (box_head, hint_adaptor, mask_head, mask_relation_ciam, relation_backward, relation_nms,
                     resnet_fpn, rpn_head)


def count(model: dict, batch: int) -> dict:
    """FLOPs by stage of one mean-teacher step of the flagship: ``batch``
    labeled images (the supervised forward with relation-NMS and CIAM on
    the sampled RoIs), ``batch`` unlabeled ones (the teacher's backbone and
    MGD adaptor over AUG_K views and their flips, its test-time detections
    and train-mode proposals on view 0, its box head over every view's
    sampled RoIs; the student's backbone, adaptor and box head over its one
    view), then the student's backward. AUG_K 2 and AUG_S 1, as the
    flagship's MT block sets them. The mask targets are ROIAlign's gather
    work (K4) and not model FLOPs."""
    views, rois, pos = 4, model["box_batch_per_image"], model["mask_max_pos"]
    test_rois = min(model["fpn_post_nms_top_n_test"], len(model["anchor_strides"]) * model["post_nms_top_n_test"])
    r = model["relation"]
    dets = min(r["detections_per_img"], (r["num_classes"] - 1) * min(r["detections_per_img"], min(r["first_n"], test_rois)))
    bb = resnet_fpn(model, batch)["backbone"]
    bb_grad = resnet_fpn(model, batch, frozen_inputs=True)
    sup_heads = (rpn_head(model, batch) + box_head(model, batch, rois) + mask_head(model, batch, pos)
                 + mask_relation_ciam(model, batch, pos))
    out = {
        "supervised_forward": bb + sup_heads + relation_nms(model, batch, rois),
        "teacher_backbone": resnet_fpn(model, views * batch)["backbone"] + hint_adaptor(model, views * batch),
        "teacher_pseudo_labels": rpn_head(model, batch) + box_head(model, batch, test_rois)
        + relation_nms(model, batch, test_rois) + mask_head(model, batch, dets) + mask_relation_ciam(model, batch, dets),
        "teacher_box_head": rpn_head(model, batch) + box_head(model, views * batch, rois),
        "student_forward": bb + hint_adaptor(model, batch) + box_head(model, batch, rois),
    }
    # PSM reads the student's class logits only: its box deltas take no gradient
    d, k = model["mlp_dim"], model["num_classes"]
    unlabeled_grad = hint_adaptor(model, batch) + box_head(model, batch, rois) - 2 * batch * rois * d * 4 * k
    out["backward"] = (2 * (2 * bb_grad["trainable"] + sup_heads + unlabeled_grad) - 2 * bb_grad["backbone"]
                       + relation_backward(model, batch, rois))
    return out
