"""The building blocks of the model FLOP counts (``perfbench/counts/
models/``), from a configuration's shapes.

Counted stage by stage as ``torch.utils.flop_counter.FlopCounterMode``
counts them (2 per multiply-add) over the convolutions, linear layers and
products of the reference: a convolution 2 x output positions x output
channels x input channels a group x kernel area (a transposed one over its
input positions), a product of [m, k] and [k, n] 2mkn. Element-wise work,
sorting, NMS and ROIAlign (the gt masks' crop to the RoIs among it) are not
model FLOPs. The RoI counts are the configuration's fixed, padded ones, so
the count does not depend on the data or on how the program runs.
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


def hint_adaptor(model: dict, batch: int, hint_dim: int = 128) -> int:
    s, c = model["image_size"], model["backbone_out_channels"]
    return sum(_conv(batch, _out(s, st) ** 2, hint_dim, c, 1) for st in model["anchor_strides"])


def relation_backward(model: dict, batch: int, rois: int) -> int:
    """Relation-NMS's backward: twice its forward, but the rank embedding's
    layer takes no input gradient (its input is a constant)."""
    r = model["relation"]
    n = min(r["first_n"], rois)
    return 2 * relation_nms(model, batch, rois) - 2 * n * r["roi_feat_dim"] * r["appearance_dim"]
