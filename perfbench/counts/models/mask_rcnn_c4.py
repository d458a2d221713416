"""One test-time forward of Mask R-CNN R-50-C4 (maskrcnn-benchmark's
``e2e_mask_rcnn_R_50_C4_1x.yaml``).

The body is the R-50 stem and stages 1 to 3, stride in the 1x1, ending at
stride 16; the RPN head runs on that one level with every anchor a
location. The ResNet stage-5 head (three bottlenecks, 1024 -> 2048
channels, stride 2 in the first 1x1: 14 x 14 pooled cells to 7 x 7) runs
on every box RoI (``box_stage5``) and again on the detections
(``mask_stage5``), the mask head sharing the box head's extractor. What
each head does beyond it is counted under the FPN counts' stage names:
``box_head``, the box predictor's two linear layers on the spatial mean;
``mask_head``, the mask predictor's 2 x 2 stride-2 transposed conv (over
its input positions) and its 1 x 1 logits.
"""

from __future__ import annotations

from ..flops import _conv, _out

BODY_BLOCKS = (3, 4, 6)  # stem to layer3
STAGE5_BLOCKS, STAGE5_BOTTLENECK, STAGE5_OUT = 3, 512, 2048


def body(model: dict, batch: int) -> int:
    """The stem and layers 1 to 3, the stride in each stage's first 1x1."""
    h = _out(model["image_size"], 2)
    total = _conv(batch, h * h, 64, 3, 7)
    h = _out(h, 2)  # max pool
    in_ch = 64
    for i, n_blocks in enumerate(BODY_BLOCKS):
        bott, out = 64 * 2**i, 256 * 2**i
        for b in range(n_blocks):
            ho = _out(h, (1 if i == 0 else 2) if b == 0 else 1)
            if in_ch != out:
                total += _conv(batch, ho * ho, out, in_ch, 1)
            total += _conv(batch, ho * ho, bott, in_ch, 1)
            total += _conv(batch, ho * ho, bott, bott, 3)
            total += _conv(batch, ho * ho, out, bott, 1)
            in_ch, h = out, ho
    return total


def rpn_head(model: dict, batch: int) -> int:
    """The 3x3 conv (1024 channels, as the program's C4 RPN) and its two
    1x1 outputs for every (size, aspect ratio) anchor on the one level."""
    c, a = model["backbone_out_channels"], len(model["aspect_ratios"]) * len(model["anchor_sizes"])
    (stride,) = model["anchor_strides"]
    hw = _out(model["image_size"], stride) ** 2
    return _conv(batch, hw, 1024, c, 3) + _conv(batch, hw, a, 1024, 1) + _conv(batch, hw, 4 * a, 1024, 1)


def stage5(model: dict, rois: int, p: int) -> int:
    """The stage-5 head on ``rois`` pooled maps of P x P x C, P = ``p``."""
    c = model["backbone_out_channels"]
    hw, bott, out = _out(p, 2) ** 2, STAGE5_BOTTLENECK, STAGE5_OUT
    total = _conv(rois, hw, out, c, 1) + _conv(rois, hw, bott, c, 1)  # the downsample, conv1 (stride 2)
    total += _conv(rois, hw, bott, bott, 3) + _conv(rois, hw, out, bott, 1)
    total += (STAGE5_BLOCKS - 1) * (_conv(rois, hw, bott, out, 1) + _conv(rois, hw, bott, bott, 3)
                                    + _conv(rois, hw, out, bott, 1))
    return total


def count(model: dict, batch: int) -> dict:
    """FLOPs by stage of one test-time forward of ``batch`` images."""
    rois = batch * min(model["fpn_post_nms_top_n_test"], model["post_nms_top_n_test"])
    dets = batch * model["detections_per_img"]
    k, pm = model["num_classes"], model["mask_pooler_resolution"]
    hw = _out(pm, 2) ** 2
    return {
        "backbone": body(model, batch),
        "rpn_head": rpn_head(model, batch),
        "box_stage5": stage5(model, rois, model["box_pooler_resolution"]),
        "box_head": 2 * rois * STAGE5_OUT * (k + 4 * k),
        "mask_stage5": stage5(model, dets, pm),
        "mask_head": _conv(dets, hw, 256, STAGE5_OUT, 2) + _conv(dets, 4 * hw, k, 256, 1),
    }
