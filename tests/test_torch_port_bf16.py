"""The port's stages under the flagship's bfloat16 against the JAX package's
on the CPU. Both models compute in bf16 (the mask relation module too) with
the same float32 weights at a 128 canvas (``torch_port_util.build_pair``);
each port stage is fed the JAX stage's own bf16 (or float32) inputs: the
backbone the images, the RPN head, the box head and the mask head the JAX
features (and its proposals, its detections), CIAM the JAX mask head's
outputs, relation-NMS the JAX box head's.

The tolerance is derived as ``chip_smoke.py``'s BF16_RTOL is: a float32 sum
rounded once to bf16 lies within one bf16 step, 2**-7 of its magnitude, of
the same sum taken in another order and rounded. Both packages round each
conv's and fc's output to bf16 once (XLA may keep elementwise chains in
float32 between them), so a stage's output differs by one such step per
rounded layer it passes through, at the scale of the layer's largest
values, and the layers' steps partly cancel. The stages are held to
STEPS = 4 steps of their largest |value| at any element and to one step on
average, and each output's dtype to JAX's; a wrong operation moves values
by O(1) of that scale (the first run measured at most 1.74 steps, mean 0.41).
Relation-NMS computes in float32 inside and is held as at float32
(tests/test_torch_port_modules.py): its sort identical, its logits 5e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.models import MaskRCNN as JM
from mmt_psm_tpu.models import rpn as jrpn
from mmt_psm_tpu.models.anchors import fpn_anchors as jfpn_anchors
from mmt_psm_tpu.models.relation import relation_nms_inference as jrel_inference

U.setup_torch()

BF16_RTOL = 2.0**-7
STEPS = 4


@pytest.fixture(scope="module")
def stages():
    jm, params, tm, _ = U.build_pair(dtype="bfloat16")
    assert tm.compute_dtype == torch.bfloat16
    c = jm.config
    images, sizes = U.inputs()
    run = lambda method, *a: jax.jit(lambda p, *a: jm.apply(p, *a, method=method))(params, *a)  # noqa: E731
    s = {"tm": tm, "images": images, "sizes": sizes}
    s["feats"] = run(JM.extract_features, images)
    s["obj"], s["reg"] = run(JM.rpn_raw, s["feats"])
    anchors = [jnp.asarray(a) for a in jfpn_anchors(c.image_size, c.anchor_strides, c.anchor_sizes, c.aspect_ratios)]
    s["props"] = jrpn.select_proposals(
        s["obj"], s["reg"], anchors, jnp.asarray(sizes), pre_nms_top_n=c.pre_nms_top_n_test,
        post_nms_top_n=c.post_nms_top_n_test, fpn_post_nms_top_n=c.fpn_post_nms_top_n_test,
        nms_thresh=c.rpn_nms_thresh, min_size=c.rpn_min_size, is_train=False,
    )
    s["logits"], s["regs"], s["box_feats"] = run(JM.box_predictions, s["feats"], s["props"].boxes)
    s["probs"] = jax.nn.softmax(s["logits"].astype(jnp.float32), axis=-1)
    s["rel"] = run(lambda m, *a: m.relation_nms(*a), s["box_feats"], s["probs"], s["regs"],
                   s["props"].boxes, s["props"].valid, jnp.asarray(sizes))
    s["dets"] = jax.vmap(functools.partial(jrel_inference, cfg=c.relation))(s["rel"])
    s["mask_logits"], s["mask_feats"] = run(JM._mask_forward, s["feats"], s["dets"][0])
    s["refined"] = run(JM._refine_masks, s["mask_logits"], s["mask_feats"], s["dets"][2], s["dets"][3])
    return s


def t(x):
    """A JAX array as a torch tensor of the same dtype (bf16 kept bf16)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return U.t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    return U.t(x)


def assert_bf16_close(got, want, what):
    """Same dtype; max error within STEPS bf16 steps of the largest |value|,
    mean error within one."""
    assert str(got.dtype).replace("torch.", "") == str(jnp.asarray(want).dtype), (what, got.dtype, want.dtype)
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, what
    err, scale = np.abs(g - w), float(np.abs(w).max())
    assert scale > 0, what
    assert err.max() <= STEPS * BF16_RTOL * scale, f"{what}: max err {err.max():.4g}, scale {scale:.4g}"
    assert err.mean() <= BF16_RTOL * scale, f"{what}: mean err {err.mean():.4g}, scale {scale:.4g}"


def test_backbone_bf16(stages):
    with torch.no_grad():
        got = stages["tm"].backbone(torch.from_numpy(stages["images"]).to(torch.bfloat16))
    assert len(got) == len(stages["feats"]) == 5
    for lv, (g, w) in enumerate(zip(got, stages["feats"])):
        assert_bf16_close(g, w, f"P{lv + 2}")


def test_rpn_head_bf16(stages):
    with torch.no_grad():
        obj, reg = stages["tm"].rpn([t(f) for f in stages["feats"]])
    for i, (g, w) in enumerate(zip(obj + reg, list(stages["obj"]) + list(stages["reg"]))):
        assert_bf16_close(g, w, f"rpn output {i}")


def test_box_head_bf16(stages):
    with torch.no_grad():
        logits, regs, feats = stages["tm"].box_forward([t(f) for f in stages["feats"]], t(stages["props"].boxes))
    assert_bf16_close(logits, stages["logits"], "class logits")
    assert_bf16_close(regs, stages["regs"], "box deltas")
    assert_bf16_close(feats, stages["box_feats"], "fc7 features")


def test_relation_nms_bf16_inputs_at_f32(stages):
    """From the JAX box head's bf16 outputs: the float32 relation head's sort
    identical, its logits 5e-5 and boxes 1e-4 as at float32; the duplicate
    removal's valid and labels identical."""
    s = stages
    with torch.no_grad():
        out = s["tm"].relation_nms(t(s["box_feats"]), t(s["probs"]), t(s["regs"]), t(s["props"].boxes),
                                   t(s["props"].valid), torch.from_numpy(s["sizes"]))
    for k in ("sorted_idx", "sorted_scores", "sorted_valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(s["rel"][k]))
    assert out["logits"].dtype == torch.float32
    U.assert_close(out["logits"], s["rel"]["logits"], atol=5e-5, what="relation logits")
    U.assert_close(out["sorted_boxes"], s["rel"]["sorted_boxes"], atol=1e-4, what="sorted boxes")
    from mmt_psm_tpu_torch.models.relation import relation_nms_inference

    _, _, labels, valid = relation_nms_inference({k: t(v) for k, v in s["rel"].items()}, s["tm"].config.relation)
    assert int(valid.sum()) > 0
    np.testing.assert_array_equal(valid.numpy(), np.asarray(s["dets"][3]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(s["dets"][2]))


def test_mask_head_bf16(stages):
    with torch.no_grad():
        logits, feats = stages["tm"].mask_forward([t(f) for f in stages["feats"]], t(stages["dets"][0]))
    assert_bf16_close(logits, stages["mask_logits"], "mask logits")
    assert_bf16_close(feats, stages["mask_feats"], "mask features")


def test_ciam_bf16(stages):
    s = stages
    with torch.no_grad():
        refined = s["tm"].roi_heads.mask.mask_relation_module(t(s["mask_feats"]), t(s["mask_logits"]),
                                                              t(s["dets"][2]), t(s["dets"][3]))
    assert_bf16_close(refined, s["refined"], "refined logits")
    assert not np.allclose(np.asarray(s["refined"].astype(jnp.float32)),
                           np.asarray(s["mask_logits"].astype(jnp.float32)))  # CIAM did act
