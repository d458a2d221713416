"""The model graphs beside the flagship, by name: each a base config and
the yacs ``KEY VALUE`` overrides that select it. Every one is a graph the
JAX package's ``ModelConfig.from_cfg`` builds.

* ``mask_rcnn_fpn``: the flagship without its IR-Net heads, the plain Mask
  R-CNN R-50-FPN of maskrcnn-benchmark's ``e2e_mask_rcnn_R_50_FPN_1x.yaml``
  (the MMT-PSM paper's supervised baseline): the greedy post-processor;
* ``set_nms``: the same with K_HEAD 2 and NMS_TYPE set: no NMS on the
  card, set-NMS on the host;
* ``mask_rel_*``: the flagship with the mask relation module's CAM and
  each of its feature extractors, one with SAME_PREDICTOR and one without
  deep supervision;
* ``rpn_only``: the flagship's RPN alone (MODEL.RPN_ONLY);
* ``mask_rcnn_c4``: the config defaults, maskrcnn-benchmark's C4 family
  (R-50-C4, the stage-5 RoI head for boxes and masks, one stride-16 level,
  pooler 14), with masks on and 3 classes; its TPU keys equal the
  flagship's (1024 canvas, bf16, 64 gt);
* ``prcnn``: ``mask_rcnn_fpn`` with the CSPN baseline's PRCNN mask head;
* ``remat``: the flagship recomputing its backbone in the backward.
"""

from __future__ import annotations

from .detector import FLAGSHIP_CONFIG, load_config

PLAIN = ["MODEL.RELATION_NMS.USE_RELATION_NMS", "False", "MODEL.RELATION_MASK.USE_RELATION", "False"]
CAM = ["MODEL.RELATION_MASK.TYPE", "CAM"]
_EXTRACTOR = "MODEL.RELATION_MASK.FEATURE_EXTRACTOR"

# name -> (YAML, None for the config defaults; overrides)
VARIANTS = {
    "mask_rcnn_fpn": (FLAGSHIP_CONFIG, PLAIN),
    "set_nms": (FLAGSHIP_CONFIG, PLAIN + ["MODEL.ROI_BOX_HEAD.K_HEAD", "2", "MODEL.ROI_HEADS.NMS_TYPE", "set"]),
    "mask_rel_cam": (FLAGSHIP_CONFIG, CAM),
    "mask_rel_same_size": (FLAGSHIP_CONFIG, CAM + [_EXTRACTOR, "SameSizeRoiAlignMaskFeatureExtractor"]),
    "mask_rel_deep": (FLAGSHIP_CONFIG, CAM + [_EXTRACTOR, "DeepFeatureExtractor"]),
    "mask_rel_mask_feature": (FLAGSHIP_CONFIG, CAM + [_EXTRACTOR, "MaskFeatureExtractor",
                                                      "MODEL.RELATION_MASK.DEEP_SUPER", "False"]),
    "mask_rel_same_predictor": (FLAGSHIP_CONFIG, CAM + [_EXTRACTOR, "SameFeatureMask",
                                                        "MODEL.RELATION_MASK.SAME_PREDICTOR", "True"]),
    "rpn_only": (FLAGSHIP_CONFIG, ["MODEL.RPN_ONLY", "True"]),
    "mask_rcnn_c4": (None, ["MODEL.ROI_BOX_HEAD.NUM_CLASSES", "3", "MODEL.MASK_ON", "True"]),
    "prcnn": (FLAGSHIP_CONFIG, PLAIN + ["MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR", "PRCNNFeatureExtractor"]),
    "remat": (FLAGSHIP_CONFIG, ["TPU.REMAT_BACKBONE", "True"]),
}


def variant_config(name: str, opts=()):
    """The config tree of variant ``name``, plus further overrides."""
    path, over = VARIANTS[name]
    return load_config(path, [*over, *opts])
