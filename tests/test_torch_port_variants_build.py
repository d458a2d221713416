"""Every graph the JAX package's ``ModelConfig.from_cfg`` builds, built by
the port (nothing compiles; each port model runs one forward at a 64
canvas in float32 on the CPU).

* each named variant (``mmt_psm_tpu_torch/models/variants.py``): the
  port's ``ModelConfig`` holds the JAX one's values field for field, and
  its parameter tree is the JAX model's (``jax.eval_shape`` of its init);
* the conv bodies (R-50-C4, R-50-FPN, R-101-FPN; R-50-C5 under the
  stage-5 head fails in both), MASK_ON off, K_HEAD without NMS_TYPE set,
  PRCNN and the C4 heads on either backbone, relation heads on C4;
* the mask relation module: each type, extractor and SAME_PREDICTOR
  setting builds in the port exactly where the JAX module initialises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.models import MaskRCNN as JaxMaskRCNN
from mmt_psm_tpu.models import ModelConfig as JaxModelConfig
from mmt_psm_tpu.models.mask_relation import MaskRelationConfig as JRelCfg
from mmt_psm_tpu.models.mask_relation import MaskRelationRefineNet as JRefine
from mmt_psm_tpu.utils.torch_import import convert_state_dict
from mmt_psm_tpu_torch.models import MaskRCNN, ModelConfig
from mmt_psm_tpu_torch.models.detector import load_config
from mmt_psm_tpu_torch.models.mask_relation import EXTRACTORS, MaskRelationConfig, MaskRelationRefineNet
from mmt_psm_tpu_torch.models.variants import VARIANTS, variant_config

U.setup_torch()

# a 64 canvas, 16 proposals, 16 sampled RoIs and 4 mask RoIs an image
TINY = dict(image_size=64, compute_dtype="float32", pre_nms_top_n_test=16, post_nms_top_n_test=16,
            fpn_post_nms_top_n_test=16, detections_per_img=8, pre_nms_top_n_train=16, post_nms_top_n_train=16,
            fpn_post_nms_top_n_train=16, box_batch_per_image=16, mask_max_pos=4, box_head_dropout=0.0)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("train", [False, True])
def test_from_cfg_reads_the_config_as_jax_does(name, train):
    jc = JaxModelConfig.from_cfg(V.jax_variant_cfg(name), train=train)
    tc = ModelConfig.from_cfg(variant_config(name), train=train)
    for f in dataclasses.fields(tc):
        want, got = getattr(jc, f.name), getattr(tc, f.name)
        if dataclasses.is_dataclass(got):  # the relation configs: the port's fields
            assert {g.name: getattr(got, g.name) for g in dataclasses.fields(got)} == \
                {g.name: getattr(want, g.name) for g in dataclasses.fields(got)}, f.name
        else:
            assert got == want, (f.name, got, want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_builds_the_jax_parameter_tree(name):
    """``variant_pair`` asserts the port's tensors, exported to the JAX
    layout, are the JAX model's parameter tree, name for name and shape for
    shape; the JAX package's torch importer (``convert_state_dict``) maps
    the port's ``state_dict`` back to the same arrays, except the tensors it
    has no rule for (the C4 stage-5 head, PRCNN's convs), which the port's
    own rules map; the port model then runs a forward."""
    jm, _, tm, flat = V.variant_pair(name, **TINY)
    assert len(flat) == len(tm.state_dict())
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_state_dict(sd, pooled_shape=(256, 7, 7))
    unmatched = back.pop("__unmatched__", [])
    assert all(k.startswith(("roi_heads.box.feature_extractor.head.", "roi_heads.mask.feature_extractor.conv",
                             "roi_heads.mask.feature_extractor.posconv")) for k in unmatched), unmatched
    assert bool(unmatched) == (name in ("mask_rcnn_c4", "prcnn"))
    assert len(back) + len(unmatched) == len(flat)
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    images = torch.randn(2, 64, 64, 3) * 40.0
    d = tm(images, torch.tensor([[64, 64], [56, 48]], dtype=torch.int32))
    assert torch.isfinite(d.boxes).all() and d.valid.dtype == torch.bool


def _build(opts, base):
    cfg = load_config(base, opts)
    jcfg = jax_get_cfg()
    if base is not None:
        jcfg.merge_from_file(base)
    jcfg.merge_from_list(list(opts))
    tc = dataclasses.replace(ModelConfig.from_cfg(cfg), **TINY)
    jc = dataclasses.replace(JaxModelConfig.from_cfg(jcfg), **TINY)
    return jc, tc


BODIES = [
    ("r50_c4", None, []),
    ("r101_fpn", "flagship", ["MODEL.BACKBONE.CONV_BODY", "R-101-FPN"]),
    ("mask_off", "flagship", ["MODEL.MASK_ON", "False"]),
    ("c4_mask_off", None, []),
    ("k_head_greedy", "flagship", V.VARIANTS["mask_rcnn_fpn"][1] + ["MODEL.ROI_BOX_HEAD.K_HEAD", "2"]),
    ("c4_prcnn", None, ["MODEL.MASK_ON", "True", "MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR", "PRCNNFeatureExtractor"]),
    ("fpn_c4_box_head", "flagship", V.VARIANTS["mask_rcnn_fpn"][1] + [
        "MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR", "ResNet50Conv5ROIFeatureExtractor",
        "MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR", "ResNet50Conv5ROIFeatureExtractor"]),
    ("c4_relation_heads", None, ["MODEL.MASK_ON", "True", "MODEL.RELATION_NMS.USE_RELATION_NMS", "True",
                                 "MODEL.RELATION_NMS.ROI_FEAT_DIM", "2048", "MODEL.RELATION_MASK.USE_RELATION",
                                 "True", "MODEL.RELATION_MASK.EXTRACTOR_CHANNEL", "16"]),
]


@pytest.mark.parametrize("what,base,opts", BODIES, ids=[b[0] for b in BODIES])
def test_other_settings_build_as_in_jax(what, base, opts):
    """The port's parameter tree is the JAX model's (``jax.eval_shape`` of
    its init), and its forward and train step run."""
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG

    jc, tc = _build(opts, FLAGSHIP_CONFIG if base == "flagship" else None)
    for f in ("conv_body", "box_extractor", "mask_extractor", "mask_on", "nms_type", "with_relation_nms"):
        assert getattr(tc, f) == getattr(jc, f), f
    tm = MaskRCNN(tc).init_weights(torch.Generator().manual_seed(0))
    flat = V.to_jax_flat(tm, (tc.backbone_out_channels, tc.box_pooler_resolution, tc.box_pooler_resolution))
    images, sizes = U.inputs(size=64)
    shapes = jax.eval_shape(lambda: JaxMaskRCNN(config=jc).init({"params": jax.random.PRNGKey(0)},
                                                                 jnp.asarray(images), jnp.asarray(sizes), train=False))
    want = {"/".join(str(getattr(k, "key", k)) for k in p[:-1]) + "." + str(p[-1].key): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    d = tm(torch.from_numpy(images), torch.from_numpy(sizes))
    assert torch.isfinite(d.boxes).all() and (d.masks is None) == (not tc.mask_on)
    tm.train()
    batch = U.train_batch(size=64)
    losses = tm.forward_train(U.t(batch["image"]), U.t(batch["image_size"]), U.torch_gt(batch), torch.Generator())
    assert all(torch.isfinite(v) for v in losses.values()) and ("loss_mask" in losses) == tc.mask_on


def _relation_inputs(s=5, p=7, roi_channels=256, key=0):
    rng = np.random.default_rng(key)
    roi = rng.normal(size=(s, p, p, roi_channels)).astype(np.float32)
    logits = rng.normal(size=(s, 2 * p, 2 * p, 3)).astype(np.float32)
    labels = rng.integers(1, 3, s).astype(np.int32)
    valid = np.array([True] * (s - 1) + [False])
    return roi, logits, labels, valid


@pytest.mark.parametrize("same_predictor", [False, True])
@pytest.mark.parametrize("extractor", EXTRACTORS)
@pytest.mark.parametrize("kind", ["CIAM", "CAM"])
def test_relation_module_setting_builds_where_jax_does(kind, extractor, same_predictor):
    """SAME_PREDICTOR hands the refined maps to the mask head's predictor,
    built for 256 channels: in both packages only extractors that give 256
    channels run with it (SameFeatureMask, or a conv stack of
    EXTRACTOR_CHANNEL 256)."""
    for channels in (16, 256):
        kw = dict(type=kind, extractor=extractor, extractor_channel=channels, same_predictor=same_predictor)
        roi, logits, labels, valid = _relation_inputs()
        args = (jnp.asarray(roi), jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
        try:
            jax.eval_shape(lambda: JRefine(config=JRelCfg(**kw)).init(jax.random.PRNGKey(0), *args))
            jax_out = True
        except Exception:
            jax_out = False
        if same_predictor and jax_out:
            # the JAX module returns the maps; the detector's shared predictor must take them
            out = jax.eval_shape(lambda: JRefine(config=JRelCfg(**kw)).apply(
                JRefine(config=JRelCfg(**kw)).init(jax.random.PRNGKey(0), *args), *args))[0]
            jax_out = out.shape[-1] == 256
        try:
            net = MaskRelationRefineNet(MaskRelationConfig(**kw), 256)
            built = True
        except ValueError:
            built = False
        assert built == jax_out, (kw, built, jax_out)
        if built:
            net.init_weights(torch.Generator().manual_seed(0))
            out = net(*(U.t(a)[None] for a in (roi, logits, labels, valid)))
            if same_predictor:
                assert out[0].shape == (5, 256, 7, 7) and out[1].shape == (1, 5, 1, 1, 1)
            else:
                assert out.shape == (1, 5, 14, 14, 3)
                # an invalid instance keeps its first-pass logits
                np.testing.assert_array_equal(out[0, -1].detach().numpy(), logits[-1])


def test_r50_c5_with_the_stage5_head_fails_in_both():
    """R-50-C5 (a STAGE_SPECS entry of both packages) under the C4 family's
    stage-5 RoI head: layer4's first block meets 2048 channels already, so
    it has no projection for its stride-2 residual, and neither package
    can add it (the JAX init fails while tracing; the port's forward)."""
    jc, tc = _build(["MODEL.BACKBONE.CONV_BODY", "R-50-C5"], None)
    images, sizes = U.inputs(size=64)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: JaxMaskRCNN(config=jc).init({"params": jax.random.PRNGKey(0)}, jnp.asarray(images),
                                                            jnp.asarray(sizes), train=False))
    tm = MaskRCNN(tc)
    assert tm.backbone.body.out_channels == 2048 and len(tm.anchors) == 1
    with pytest.raises(RuntimeError, match="size of tensor"):
        tm(torch.from_numpy(images), torch.from_numpy(sizes))
