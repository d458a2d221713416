"""One test-time forward of a Mask R-CNN FPN model, with relation-NMS and
CIAM where the configuration has them."""

from __future__ import annotations

from ..flops import box_head, mask_head, mask_relation_ciam, relation_nms, resnet_fpn, rpn_head


def count(model: dict, batch: int) -> dict:
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
