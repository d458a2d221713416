"""Load the JAX package's parameters into the port's modules.

Input: the flat ``{'a/b/c.leaf': ndarray}`` map of a flax param tree (the
form ``mmt_psm_tpu/utils/torch_import.py`` produces), as numpy arrays.
The port's ``state_dict`` uses maskrcnn-benchmark's names, so each port
key is mapped to its flax key by the same name rules as that importer,
and each array's layout is converted back:

* conv: flax HWIO -> OIHW;
* deconv: flax (kh, kw, in, out) with the taps flipped -> torch
  ConvTranspose2d (in, out, kh, kw), flip undone;
* linear: (in, out) -> (out, in); fc6 also reorders its input axis from
  the JAX (H, W, C) flatten order to the reference's (C, H, W);
* FrozenBN buffers and raw parameters (CIAM's gamma) as they are.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# port (maskrcnn-benchmark) name prefix -> (flax path prefix, kind); the
# rules of mmt_psm_tpu/utils/torch_import.py for the modules the port has,
# and the same rules for the C4 stage-5 head, PRCNN's convs and ShapeBuffer,
# which that importer does not map
_RULES = [
    (r"^backbone\.body\.stem\.conv1", ("backbone/body/stem/conv1", "conv")),
    (r"^backbone\.body\.stem\.bn1", ("backbone/body/stem/bn1", "bn")),
    (r"^backbone\.body\.layer(\d)\.(\d+)\.conv(\d)", (r"backbone/body/layer\1_\2/conv\3", "conv")),
    (r"^backbone\.body\.layer(\d)\.(\d+)\.bn(\d)", (r"backbone/body/layer\1_\2/bn\3", "bn")),
    (r"^backbone\.body\.layer(\d)\.(\d+)\.downsample\.0", (r"backbone/body/layer\1_\2/downsample_conv", "conv")),
    (r"^backbone\.body\.layer(\d)\.(\d+)\.downsample\.1", (r"backbone/body/layer\1_\2/downsample_bn", "bn")),
    (r"^backbone\.fpn\.fpn_inner(\d)", (r"backbone/fpn/fpn_inner\1", "conv")),
    (r"^backbone\.fpn\.fpn_layer(\d)", (r"backbone/fpn/fpn_layer\1", "conv")),
    (r"^rpn\.head\.conv", ("rpn/conv", "conv")),
    (r"^rpn\.head\.cls_logits", ("rpn/cls_logits", "conv")),
    (r"^rpn\.head\.bbox_pred", ("rpn/bbox_pred", "conv")),
    # the C4 box head's stage-5 extractor (roi_box_feature_extractors.py:12-42)
    (r"^roi_heads\.box\.feature_extractor\.head\.layer4\.(\d+)\.conv(\d)",
     (r"box_extractor/head/layer4_\1/conv\2", "conv")),
    (r"^roi_heads\.box\.feature_extractor\.head\.layer4\.(\d+)\.bn(\d)",
     (r"box_extractor/head/layer4_\1/bn\2", "bn")),
    (r"^roi_heads\.box\.feature_extractor\.head\.layer4\.(\d+)\.downsample\.0",
     (r"box_extractor/head/layer4_\1/downsample_conv", "conv")),
    (r"^roi_heads\.box\.feature_extractor\.head\.layer4\.(\d+)\.downsample\.1",
     (r"box_extractor/head/layer4_\1/downsample_bn", "bn")),
    (r"^roi_heads\.box\.feature_extractor\.fc6", ("box_extractor/fc6", "linear_chw")),
    (r"^roi_heads\.box\.feature_extractor\.fc7", ("box_extractor/fc7", "linear")),
    (r"^roi_heads\.box\.predictor\.cls_score", ("box_predictor/cls_score", "linear")),
    (r"^roi_heads\.box\.predictor\.bbox_pred", ("box_predictor/bbox_pred", "linear")),
    (r"^roi_heads\.mask\.feature_extractor\.mask_fcn(\d)", (r"mask_extractor/mask_fcn\1", "conv")),
    # the PRCNN extractor's tower and fusion convs
    (r"^roi_heads\.mask\.feature_extractor\.((?:pos)?conv\d)", (r"mask_extractor/\1", "conv")),
    (r"^roi_heads\.mask\.predictor\.conv5_mask", ("mask_predictor/conv5_mask", "deconv")),
    (r"^roi_heads\.mask\.predictor\.mask_fcn_logits", ("mask_predictor/mask_fcn_logits", "conv")),
    (r"^hint_adaptor\.adapter_(\d)", (r"hint_adaptor/adapter_\1", "conv")),
    (r"^relation_nms\.nms_rank_fc", ("relation_nms/nms_rank_fc", "linear")),
    (r"^relation_nms\.roi_feat_embedding_fc", ("relation_nms/roi_feat_embedding_fc", "linear")),
    (r"^relation_nms\.classifier", ("relation_nms/classifier", "linear")),
    (r"^relation_nms\.relation_module\.WG", ("relation_nms/relation_module/WG", "linear")),
    (r"^relation_nms\.relation_module\.WK", ("relation_nms/relation_module/WK", "linear")),
    (r"^relation_nms\.relation_module\.WQ", ("relation_nms/relation_module/WQ", "linear")),
    (r"^relation_nms\.relation_module\.conv1", ("relation_nms/relation_module/conv1", "conv")),
    (r"^roi_heads\.mask\.mask_relation_module\.appearance_feature_extractor\.mask_fcn(\d)",
     (r"mask_relation/mask_fcn\1", "conv")),
    (r"^roi_heads\.mask\.mask_relation_module\.appearance_feature_extractor\.conv5_mask",
     ("mask_relation/extractor_conv5", "conv")),
    (r"^roi_heads\.mask\.mask_relation_module\.classifier", ("mask_relation/classifier", "conv")),
    (r"^roi_heads\.mask\.mask_relation_module\.deconv_1", ("mask_relation/deconv_1", "deconv")),
    (r"^roi_heads\.mask\.mask_relation_module\.relation_module(?=\.gamma)", ("mask_relation", "raw")),
    (r"^shape_buffer(?=\.center)", ("shape_buffer", "raw")),
]


def flax_key(name: str) -> tuple[str, str]:
    """Port state_dict name -> (flat flax key, layout kind)."""
    for pat, (repl, kind) in _RULES:
        m = re.match(pat, name)
        if m:
            leaf = name[m.end():].lstrip(".")
            prefix = m.expand(repl) if "\\" in repl else repl
            if kind not in ("bn", "raw"):
                leaf = {"weight": "kernel", "bias": "bias"}[leaf]
            return f"{prefix}.{leaf}", kind
    raise KeyError(f"no JAX parameter rule for {name!r}")


def _to_torch_layout(kind: str, key: str, v: np.ndarray, pooled_chw) -> np.ndarray:
    if kind in ("bn", "raw") or key.endswith(".bias"):
        return v
    if kind == "conv":
        return v.transpose(3, 2, 0, 1)
    if kind == "deconv":
        return v[::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "linear":
        return v.T
    if kind == "linear_chw":
        c, h, w = pooled_chw
        out = v.shape[1]
        return v.T.reshape(out, h, w, c).transpose(0, 3, 1, 2).reshape(out, c * h * w)
    raise ValueError(kind)


def load_jax_params(model: torch.nn.Module, flat: Dict[str, np.ndarray], pooled_chw=(256, 7, 7)) -> None:
    """Copy every parameter and buffer of ``model.state_dict()`` from ``flat``.

    Raises if a port tensor has no JAX counterpart or the shapes disagree,
    so a partial load cannot pass silently.
    """
    sd = model.state_dict()
    new = {}
    for name, t in sd.items():
        key, kind = flax_key(name)
        if key not in flat:
            raise KeyError(f"{name}: JAX parameter {key!r} missing")
        v = np.array(_to_torch_layout(kind, key, np.asarray(flat[key]), pooled_chw), order="C")
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX {key} gives {v.shape}, port wants {tuple(t.shape)}")
        new[name] = torch.from_numpy(v).to(dtype=t.dtype)
    model.load_state_dict(new)
