"""Default configuration tree for the inference path.

The keys of the JAX package's ``config/defaults.py`` (which mirrors the
reference's yacs key space, maskrcnn_benchmark/config/defaults.py) that
the port's ``ModelConfig.from_cfg`` reads, with the same defaults, so
``configs/pap/*.yaml`` merges unchanged. Other keys in a YAML (SOLVER,
MT, DATASETS, ...) merge in as plain values.
"""

from .node import ConfigNode


def get_cfg() -> ConfigNode:
    """Return a fresh, mutable copy of the default config."""
    C = ConfigNode()

    C.MODEL = ConfigNode()
    C.MODEL.RPN_ONLY = False
    C.MODEL.MASK_ON = False

    C.MODEL.BACKBONE = ConfigNode()
    C.MODEL.BACKBONE.CONV_BODY = "R-50-C4"
    C.MODEL.BACKBONE.OUT_CHANNELS = 256 * 4

    C.MODEL.RPN = ConfigNode()
    C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
    C.MODEL.RPN.ANCHOR_STRIDE = (16,)
    C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
    C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
    C.MODEL.RPN.POST_NMS_TOP_N_TEST = 1000
    C.MODEL.RPN.NMS_THRESH = 0.7
    C.MODEL.RPN.MIN_SIZE = 0
    C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 2000

    C.MODEL.ROI_HEADS = ConfigNode()
    C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    C.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 200

    C.MODEL.ROI_BOX_HEAD = ConfigNode()
    C.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
    C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    C.MODEL.ROI_BOX_HEAD.POOLER_SCALES = (1.0 / 16,)
    C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 3
    C.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 1024

    C.MODEL.ROI_MASK_HEAD = ConfigNode()
    C.MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
    C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0

    C.MODEL.RELATION_NMS = ConfigNode()
    C.MODEL.RELATION_NMS.FIRST_N = 100
    C.MODEL.RELATION_NMS.THREAD = (0.5, 0.6, 0.7, 0.8, 0.9)
    C.MODEL.RELATION_NMS.ROI_FEAT_DIM = 1024
    C.MODEL.RELATION_NMS.APPEARANCE_FEAT_DIM = 128
    C.MODEL.RELATION_NMS.GEO_FEAT_DIM = 64
    C.MODEL.RELATION_NMS.GROUP = 16
    C.MODEL.RELATION_NMS.HID_DIM = (1024, 1024, 1024)
    C.MODEL.RELATION_NMS.USE_RELATION_NMS = False
    C.MODEL.RELATION_NMS.MERGE_METHOD = 0
    C.MODEL.RELATION_NMS.FG_THREAD = 0.05
    C.MODEL.RELATION_NMS.POS_NMS = -1.0
    C.MODEL.RELATION_NMS.TOPK = 90
    C.MODEL.RELATION_NMS.REG_IOU = False

    C.MODEL.RELATION_MASK = ConfigNode()
    C.MODEL.RELATION_MASK.PRE_NORM = False
    C.MODEL.RELATION_MASK.NORM = 1
    C.MODEL.RELATION_MASK.TYPE = "CAM"
    C.MODEL.RELATION_MASK.SAME_PREDICTOR = False
    C.MODEL.RELATION_MASK.DEEP_SUPER = True
    C.MODEL.RELATION_MASK.USE_RELATION = False
    C.MODEL.RELATION_MASK.EXTRACTOR_CHANNEL = 1
    C.MODEL.RELATION_MASK.FEATURE_EXTRACTOR = "RoiAlignMaskFeatureExtractor"

    # static-shape knobs: every image is padded to IMAGE_SIZE square
    C.TPU = ConfigNode()
    C.TPU.IMAGE_SIZE = 1024
    C.TPU.COMPUTE_DTYPE = "bfloat16"
    return C
