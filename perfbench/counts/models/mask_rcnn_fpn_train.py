"""One supervised training step of the plain Mask R-CNN FPN model."""

from __future__ import annotations

from ..flops import box_head, mask_head, resnet_fpn, rpn_head


def count(model: dict, batch: int) -> dict:
    """FLOPs by stage of one supervised training step of ``batch`` images:
    the forward on the sampled RoIs, then the backward, which costs twice
    the forward of every layer that trains (input and weight gradients)
    except the input gradients that nothing needs: none for the frozen
    stem and layer1, none into layer1's output. The mask targets, each
    positive's gt mask cropped to its box, are ROIAlign's gather work (K4)
    and not model FLOPs."""
    if model["with_relation_nms"] or model["with_relation_mask"]:
        raise ValueError("the training count covers the plain Mask R-CNN only")
    rois, pos = model["box_batch_per_image"], model["mask_max_pos"]
    fwd = resnet_fpn(model, batch)
    fwd["rpn_head"] = rpn_head(model, batch)
    fwd["box_head"] = box_head(model, batch, rois)
    fwd["mask_head"] = mask_head(model, batch, pos)
    bb = resnet_fpn(model, batch, frozen_inputs=True)
    heads = fwd["rpn_head"] + fwd["box_head"] + fwd["mask_head"]
    out = {f"{k}_forward": v for k, v in fwd.items()}
    out["backward"] = 2 * (bb["trainable"] + heads) - bb["backbone"]
    return out
