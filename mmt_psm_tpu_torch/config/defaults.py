"""Default configuration tree for the inference, serving, supervised and
mean-teacher training paths.

The keys of the JAX package's ``config/defaults.py`` (which mirrors the
reference's yacs key space, maskrcnn_benchmark/config/defaults.py) that
the port's ``ModelConfig.from_cfg``, its optimizer, ``MTConfig.from_cfg``,
the training loop (``engine/trainer.py``) and the two CLIs
(``tools/test_net.py``, ``tools/train_mean_teacher.py``) read, with the same defaults, so
``configs/pap/*.yaml`` merges unchanged; the whole MT block is copied, so
a YAML that is silent on a key (ODKD, FFI, PLTRAIN, ...) gets the JAX
default. Other keys in a YAML merge in as plain values.
"""

from .node import ConfigNode


def get_cfg() -> ConfigNode:
    """Return a fresh, mutable copy of the default config."""
    C = ConfigNode()

    C.MODEL = ConfigNode()
    C.MODEL.RPN_ONLY = False
    C.MODEL.MASK_ON = False

    C.INPUT = ConfigNode()
    C.INPUT.MIN_SIZE_TRAIN = 800
    C.INPUT.MIN_SIZE_TEST = 800
    C.INPUT.MAX_SIZE_TEST = 1333
    # BGR 0-255 pixel normalization (reference config/defaults.py:48-52)
    C.INPUT.PIXEL_MEAN = [102.9801, 115.9465, 122.7717]
    C.INPUT.PIXEL_STD = [1.0, 1.0, 1.0]

    C.DATASETS = ConfigNode()
    C.DATASETS.TRAIN = ()
    C.DATASETS.TEST = ()
    C.DATASETS.VAL = ("papnuclei_val",)
    C.DATASETS.GEN = ("papnuclei_no_label",)
    C.DATASETS.MODE_IN_TEST = "val"
    # train with the unlabeled split (DATASETS.GEN) past MT.START_MT
    C.DATASETS.NO_LABEL = True

    C.DATALOADER = ConfigNode()
    C.DATALOADER.SIZE_DIVISIBILITY = 0
    # train and test batches assembled ahead in a background thread
    # (data/loader.py prefetch): 0 synchronous, -1 auto (2 with a spare core)
    C.DATALOADER.PREFETCH_DEPTH = -1

    C.MODEL.BACKBONE = ConfigNode()
    C.MODEL.BACKBONE.CONV_BODY = "R-50-C4"
    C.MODEL.BACKBONE.OUT_CHANNELS = 256 * 4
    C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 2

    C.MODEL.RPN = ConfigNode()
    C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
    C.MODEL.RPN.ANCHOR_STRIDE = (16,)
    C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
    C.MODEL.RPN.STRADDLE_THRESH = 0
    C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
    C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
    C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 12000
    C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
    C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 2000
    C.MODEL.RPN.POST_NMS_TOP_N_TEST = 1000
    C.MODEL.RPN.NMS_THRESH = 0.7
    C.MODEL.RPN.MIN_SIZE = 0
    C.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 2000
    C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 2000

    C.MODEL.ROI_HEADS = ConfigNode()
    C.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.5
    C.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.5
    C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    C.MODEL.ROI_HEADS.SCORE_THRESH = 0.05
    C.MODEL.ROI_HEADS.NMS = 0.5
    # "set" with ROI_BOX_HEAD.K_HEAD > 1: set-NMS on the host (engine/inference.py)
    C.MODEL.ROI_HEADS.NMS_TYPE = "basic"
    C.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 200

    C.MODEL.ROI_BOX_HEAD = ConfigNode()
    C.MODEL.ROI_BOX_HEAD.DO = 0.0
    C.MODEL.ROI_BOX_HEAD.K_HEAD = 1.0
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
    C.MODEL.RELATION_NMS.LOSS = 1.0

    C.MODEL.RELATION_MASK = ConfigNode()
    C.MODEL.RELATION_MASK.PRE_NORM = False
    C.MODEL.RELATION_MASK.NORM = 1
    C.MODEL.RELATION_MASK.TYPE = "CAM"
    C.MODEL.RELATION_MASK.SAME_PREDICTOR = False
    C.MODEL.RELATION_MASK.DEEP_SUPER = True
    C.MODEL.RELATION_MASK.USE_RELATION = False
    C.MODEL.RELATION_MASK.EXTRACTOR_CHANNEL = 1
    C.MODEL.RELATION_MASK.FEATURE_EXTRACTOR = "RoiAlignMaskFeatureExtractor"

    C.MT = ConfigNode()
    C.MT.ALPHA_RAMPUP = 0.99
    C.MT.ALPHA = 0.999
    C.MT.LAMBDA = 1.0
    C.MT.RAMPUP_STEP = 5000
    C.MT.RAMPDOWN_STEP = 2000
    C.MT.SEG_LOSS = 1.0
    C.MT.NMS_LOSS = 1.0
    C.MT.OBJ_LOSS = 1.0
    C.MT.RPN_REG_LOSS = 1.0
    C.MT.CLS_LOSS = 1.0
    C.MT.BOX_REG_LOSS = 1.0
    C.MT.NMS_LOSS_TYPE = "weighted_bce"
    C.MT.CLS_LOSS_TYPE = "bce"
    C.MT.REG_LOSS_TYPE = "smooth_l1"
    C.MT.SEG_LOSS_TYPE = "bce"
    C.MT.RPN_BOOST_ALPHA = 0.5
    C.MT.TEMP = 0.5
    C.MT.HINT = 0.0
    C.MT.FLIP = False
    C.MT.START = 5000
    C.MT.CONSIST_ONLY_NO_LABEL = False
    C.MT.ADV = False
    C.MT.G_LOSS = 1.0
    C.MT.CONFIDENCE = 0.0
    C.MT.CONF_PAIR = False
    C.MT.SHARPEN = False
    C.MT.CONSIST_TEACHER = False
    C.MT.RANK_FILTER = 0.0
    C.MT.IG_LOSS = 0.0
    C.MT.MEAN_TARGET = True
    C.MT.CLS_NEG = True
    C.MT.AUG = False
    C.MT.ANNEAL = 0.0
    C.MT.TSG_LOSS = 0.0
    C.MT.SAME_DIR = False
    C.MT.HARD_NEG = False
    C.MT.START_MT = 1000
    C.MT.FG_HINT = 0.0
    C.MT.T_ADAPT = False
    C.MT.CLS_BALANCE_WEIGHT = 1.0
    C.MT.AUG_K = 2
    C.MT.AUG_S = 1
    C.MT.N_STEP_UNLABEL = 1
    C.MT.ODKD = False
    C.MT.FFI = False
    C.MT.PLTRAIN = False

    C.SOLVER = ConfigNode()
    C.SOLVER.MAX_ITER = 40000
    C.SOLVER.BASE_LR = 0.001
    C.SOLVER.BIAS_LR_FACTOR = 2
    C.SOLVER.MOMENTUM = 0.9
    C.SOLVER.WEIGHT_DECAY = 0.0005
    C.SOLVER.WEIGHT_DECAY_BIAS = 0.0
    C.SOLVER.GAMMA = 0.1
    C.SOLVER.STEPS = (30000,)
    C.SOLVER.WARMUP_FACTOR = 1.0 / 3
    C.SOLVER.WARMUP_ITERS = 500
    C.SOLVER.WARMUP_METHOD = "linear"
    C.SOLVER.CHECKPOINT_PERIOD = 500
    # 0 disables; > 0 clips the global gradient norm
    C.SOLVER.CLIP_GRAD_NORM = 0.0
    C.SOLVER.IMS_PER_BATCH = 4

    C.TEST = ConfigNode()
    # (metric path, mean, std) rows checked by engine.inference.check_expected_results
    C.TEST.EXPECTED_RESULTS = []
    C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4
    C.TEST.IMS_PER_BATCH = 1
    C.TEST.GEN = False
    C.TEST.TTA = False
    C.TEST.VISUAL_NUM = 0
    # processes that paste and score images (engine/_eval_worker.py): 0
    # serial, -1 auto (one per spare core, serial without spare cores)
    C.TEST.EVAL_WORKERS = -1

    # static-shape knobs: every image is padded to IMAGE_SIZE square and
    # carries MAX_GT ground-truth rows
    C.TPU = ConfigNode()
    C.TPU.IMAGE_SIZE = 1024
    C.TPU.MAX_GT = 64
    C.TPU.COMPUTE_DTYPE = "bfloat16"
    # recompute each backbone bottleneck in the backward (torch.utils.checkpoint)
    # instead of keeping its activations; the gradients do not change
    C.TPU.REMAT_BACKBONE = False
    # devices of the data-parallel mesh, -1 all of them: the port's loop
    # runs on one device (engine/trainer.py)
    C.TPU.MESH_SHAPE = (-1,)
    # a torch.profiler trace of iterations [PROFILE_START, PROFILE_START +
    # PROFILE_STEPS) is written into PROFILE_DIR; empty: off
    C.TPU.PROFILE_DIR = ""
    C.TPU.PROFILE_START = 5
    C.TPU.PROFILE_STEPS = 3
    return C
