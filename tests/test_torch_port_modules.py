"""Each module of the port's inference slice against its JAX counterpart.

Both models are built at a 128 canvas in float32 on the CPU with the same
weights (``torch_port_util.build_pair``). Each stage of the port is fed
the JAX stage's inputs, so a discrete choice (top-k, NMS) downstream never
sees the upstream float noise. Tolerances are stated per stage; they cover
float32 sums taken in another order by XLA and by PyTorch's CPU kernels.
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
from mmt_psm_tpu.models.mask_head import select_mask_probs as jselect
from mmt_psm_tpu.models.relation import relation_nms_inference as jrel_inference
from mmt_psm_tpu.utils.torch_import import convert_state_dict
from mmt_psm_tpu_torch.models.mask_head import select_mask_probs
from mmt_psm_tpu_torch.models.relation import relation_nms_inference
from mmt_psm_tpu_torch.models.rpn import select_proposals

U.setup_torch()


@pytest.fixture(scope="module")
def stages():
    jm, params, tm, flat = U.build_pair()
    c = jm.config
    images, sizes = U.inputs()
    run = lambda method, *a: jax.jit(lambda p, *a: jm.apply(p, *a, method=method))(params, *a)  # noqa: E731
    s = {"jm": jm, "tm": tm, "flat": flat, "images": images, "sizes": sizes}
    s["feats"] = run(JM.extract_features, images)
    s["obj"], s["reg"] = run(JM.rpn_raw, s["feats"])
    anchors = [jnp.asarray(a) for a in jfpn_anchors(c.image_size, c.anchor_strides, c.anchor_sizes, c.aspect_ratios)]
    s["props"] = jrpn.select_proposals(
        s["obj"], s["reg"], anchors, jnp.asarray(sizes), pre_nms_top_n=c.pre_nms_top_n_test,
        post_nms_top_n=c.post_nms_top_n_test, fpn_post_nms_top_n=c.fpn_post_nms_top_n_test,
        nms_thresh=c.rpn_nms_thresh, min_size=c.rpn_min_size, is_train=False,
    )
    s["logits"], s["regs"], s["box_feats"] = run(JM.box_predictions, s["feats"], s["props"].boxes)
    s["probs"] = jax.nn.softmax(s["logits"], axis=-1)
    s["rel"] = run(lambda m, *a: m.relation_nms(*a), s["box_feats"], s["probs"], s["regs"],
                   s["props"].boxes, s["props"].valid, jnp.asarray(sizes))
    s["dets"] = jax.vmap(functools.partial(jrel_inference, cfg=c.relation))(s["rel"])
    s["mask_logits"], s["mask_feats"] = run(JM._mask_forward, s["feats"], s["dets"][0])
    s["refined"] = run(JM._refine_masks, s["mask_logits"], s["mask_feats"], s["dets"][2], s["dets"][3])
    return s


def _scale(x):
    return float(np.abs(np.asarray(x)).max())


def test_backbone_features(stages):
    """P2..P6 NHWC; ~50 f32 convs summed in another order: 2e-5 of the level's range."""
    with torch.no_grad():
        got = stages["tm"].backbone(torch.from_numpy(stages["images"]))
    assert len(got) == len(stages["feats"]) == 5
    for g, w in zip(got, stages["feats"]):
        U.assert_close(g, w, atol=2e-5 * _scale(w), what="feature level")


def test_rpn_head(stages):
    """Raw objectness and deltas from the JAX features: 3e-5 abs."""
    with torch.no_grad():
        obj, reg = stages["tm"].rpn([U.t(f) for f in stages["feats"]])
    for g, w in zip(obj + reg, list(stages["obj"]) + list(stages["reg"])):
        U.assert_close(g, w, atol=3e-5, what="rpn output")


def test_select_proposals(stages):
    """Same proposals from the JAX head outputs: valid identical, boxes 1e-4
    abs (coordinates up to 127 px), scores 1e-6 abs."""
    tm = stages["tm"]
    c = tm.config
    p = select_proposals(
        [U.t(x) for x in stages["obj"]], [U.t(x) for x in stages["reg"]], tm.anchors,
        torch.from_numpy(stages["sizes"]), pre_nms_top_n=c.pre_nms_top_n_test,
        post_nms_top_n=c.post_nms_top_n_test, fpn_post_nms_top_n=c.fpn_post_nms_top_n_test,
        nms_thresh=c.rpn_nms_thresh, min_size=c.rpn_min_size,
    )
    jp = stages["props"]
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(jp.valid))
    U.assert_close(p.boxes, jp.boxes, atol=1e-4, what="proposal boxes")
    U.assert_close(p.scores, jp.scores, atol=1e-6, what="proposal scores")


def test_box_head(stages):
    """Pooling + fc6/fc7 + predictor from JAX features and proposals:
    logits and deltas 2e-5 abs, fc7 features 2e-4 abs (range ~10)."""
    with torch.no_grad():
        logits, regs, feats = stages["tm"].box_forward([U.t(f) for f in stages["feats"]], U.t(stages["props"].boxes))
    U.assert_close(logits, stages["logits"], atol=2e-5, what="class logits")
    U.assert_close(regs, stages["regs"], atol=2e-5, what="box deltas")
    U.assert_close(feats, stages["box_feats"], atol=2e-4, what="fc7 features")


def test_relation_nms(stages):
    """The learned NMS head from JAX box outputs: the sort (indices, scores,
    valid) identical, logits 5e-5 abs, boxes 1e-4 abs; then the test-time
    duplicate removal from the JAX head outputs: valid and labels identical,
    boxes and scores exact to 1e-6."""
    s = stages
    with torch.no_grad():
        out = s["tm"].relation_nms(U.t(s["box_feats"]), U.t(s["probs"]), U.t(s["regs"]), U.t(s["props"].boxes),
                                   U.t(s["props"].valid), torch.from_numpy(s["sizes"]))
    for k in ("sorted_idx", "sorted_scores", "sorted_valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(s["rel"][k]))
    U.assert_close(out["logits"], s["rel"]["logits"], atol=5e-5, what="relation logits")
    U.assert_close(out["sorted_boxes"], s["rel"]["sorted_boxes"], atol=1e-4, what="sorted boxes")

    boxes, scores, labels, valid = relation_nms_inference({k: U.t(v) for k, v in s["rel"].items()}, s["tm"].config.relation)
    jb, js, jl, jv = s["dets"]
    assert int(np.asarray(jv).sum()) > 0
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    U.assert_close(boxes, jb, atol=1e-6, what="detection boxes")
    U.assert_close(scores, js, atol=1e-6, what="detection scores")


def test_mask_head(stages):
    """Mask pooling + 4 convs + deconv from JAX features and detections:
    logits and features 2e-5 of their range."""
    with torch.no_grad():
        logits, feats = stages["tm"].mask_forward([U.t(f) for f in stages["feats"]], U.t(stages["dets"][0]))
    U.assert_close(logits, stages["mask_logits"], atol=2e-5 * _scale(stages["mask_logits"]), what="mask logits")
    U.assert_close(feats, stages["mask_feats"], atol=2e-5 * _scale(stages["mask_feats"]), what="mask features")


def test_ciam_and_mask_probs(stages):
    """CIAM refinement (gamma 0.5) from the JAX first-pass logits: 2e-5 of
    the range; per-label probabilities 1e-6 abs."""
    s = stages
    _, _, labels, valid = s["dets"]
    with torch.no_grad():
        refined = s["tm"].roi_heads.mask.mask_relation_module(U.t(s["mask_feats"]), U.t(s["mask_logits"]),
                                                              U.t(labels), U.t(valid))
    U.assert_close(refined, s["refined"], atol=2e-5 * _scale(s["refined"]), what="refined logits")
    assert not np.allclose(np.asarray(s["refined"]), np.asarray(s["mask_logits"]))  # CIAM did act
    probs = select_mask_probs(U.t(s["refined"]), U.t(labels))
    U.assert_close(probs, jselect(s["refined"], labels), atol=1e-6, what="mask probabilities")


def test_weight_round_trip(stages):
    """JAX params -> port -> the JAX package's torch importer -> the same arrays."""
    sd = {k: v.numpy() for k, v in stages["tm"].state_dict().items()}
    back = convert_state_dict(sd)
    assert "__unmatched__" not in back
    assert set(back) == set(stages["flat"])
    for k, v in back.items():
        np.testing.assert_array_equal(v, stages["flat"][k], err_msg=k)


def test_bf16_stage_dtypes_follow_jax():
    """Under the flagship's bf16 compute dtype each stage returns the dtype
    the JAX model returns: bf16 convs and fcs, f32 where the JAX model
    casts (RPN decode, softmax, relation-NMS, CIAM core, mask
    probabilities). JAX dtypes come from ``jax.eval_shape``."""
    import dataclasses

    jc, tc = U.configs()
    jc = dataclasses.replace(jc, compute_dtype="bfloat16",
                             relation_mask=dataclasses.replace(jc.relation_mask, compute_dtype="bfloat16"))
    tc = dataclasses.replace(tc, compute_dtype="bfloat16",
                             relation_mask=dataclasses.replace(tc.relation_mask, compute_dtype="bfloat16"))
    images, sizes = U.inputs(batch=1)
    jm = JM(config=jc)
    sds = lambda a: jax.ShapeDtypeStruct(np.shape(a), jnp.asarray(a).dtype)  # noqa: E731
    pshape = jax.eval_shape(lambda i, s: jm.init({"params": jax.random.PRNGKey(0)}, i, s, train=False),
                            sds(images), sds(sizes))
    ev = lambda method, *a: jax.eval_shape(lambda p, *a: jm.apply(p, *a, method=method), pshape, *a)  # noqa: E731
    j_feats = ev(JM.extract_features, sds(images))
    j_box = ev(JM.box_predictions, j_feats, jax.ShapeDtypeStruct((1, 64, 4), jnp.float32))
    j_dets = jax.eval_shape(lambda p, i, s: jm.apply(p, i, s, train=False), pshape, sds(images), sds(sizes))

    from mmt_psm_tpu_torch.models import MaskRCNN

    tm = MaskRCNN(tc).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        feats = tm.backbone(torch.from_numpy(images).to(tm.compute_dtype))
        box = tm.box_forward(feats, torch.tensor([[[0.0, 0.0, 40.0, 50.0]] * 64]))
        dets = tm(torch.from_numpy(images), torch.from_numpy(sizes))
    name = lambda d: str(d).replace("torch.", "")  # noqa: E731
    assert [name(f.dtype) for f in feats] == [str(f.dtype) for f in j_feats]
    assert [name(x.dtype) for x in box] == [str(x.dtype) for x in j_box]
    for k in ("boxes", "scores", "labels", "valid", "masks"):
        assert name(getattr(dets, k).dtype) == str(getattr(j_dets, k).dtype), k


def test_select_proposals_levels_shorter_than_post_nms():
    """Levels with fewer anchors than pre/post_nms_top_n (P4..P6 at a 128
    canvas with 200 per level, like P6's 768 < 1000 at 1024): the port pads
    them into one NMS launch and must still give the JAX per-level result,
    index-0 padding slots included. Valid identical, boxes 1e-4 abs."""
    from mmt_psm_tpu_torch.models.anchors import fpn_anchors

    rng = np.random.default_rng(11)
    strides, sizes_a, ratios = (4, 8, 16, 32, 64), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
    obj = [rng.normal(0, 2, (2, 128 // s, 128 // s, 3)).astype(np.float32) for s in strides]
    reg = [rng.normal(0, 0.3, (2, 128 // s, 128 // s, 12)).astype(np.float32) for s in strides]
    img_sizes = np.array([[128, 128], [100, 120]], np.int32)
    # fpn_post = all 5 x 200 slots, so the padding slots reach the output too
    kw = dict(pre_nms_top_n=200, post_nms_top_n=200, fpn_post_nms_top_n=1000, nms_thresh=0.7, min_size=0.0)
    janchors = [jnp.asarray(a) for a in jfpn_anchors(128, strides, sizes_a, ratios)]
    want = jrpn.select_proposals([jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg], janchors,
                                 jnp.asarray(img_sizes), is_train=False, **kw)
    got = select_proposals([torch.from_numpy(o) for o in obj], [torch.from_numpy(r) for r in reg],
                           [torch.from_numpy(a) for a in fpn_anchors(128, strides, sizes_a, ratios)],
                           torch.from_numpy(img_sizes), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    U.assert_close(got.boxes, want.boxes, atol=1e-4, what="proposal boxes")
    U.assert_close(got.scores, want.scores, atol=1e-6, what="proposal scores")
