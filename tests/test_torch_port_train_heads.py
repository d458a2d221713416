"""Each training stage of the port fed the JAX stage's inputs.

The RPN loss and train-mode proposal selection, the box head's sampling
and loss, the mask head's targets and loss, the relation-NMS loss
(REG_IOU on and off) and CIAM under autograd: values, and gradients with
respect to the stage's inputs and parameters, against the JAX functions
with the same inputs (seeded numpy) and the same sampler draws
(``torch_port_util.same_draws``). Discrete outputs must be identical;
float32 values agree to 1e-5 relative and gradients to 1e-4 of their
largest magnitude (sums taken in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.models import MaskRCNN as JM
from mmt_psm_tpu.models import box_head as jbh
from mmt_psm_tpu.models import mask_head as jmh
from mmt_psm_tpu.models import relation as jrel
from mmt_psm_tpu.models import rpn as jrpn
from mmt_psm_tpu.models.anchors import fpn_anchors as jfpn_anchors
from mmt_psm_tpu.structures.detections import Proposals as JProposals
from mmt_psm_tpu_torch.models import box_head as bh
from mmt_psm_tpu_torch.models import mask_head as mh
from mmt_psm_tpu_torch.models import relation as rel
from mmt_psm_tpu_torch.models import rpn
from mmt_psm_tpu_torch.models.anchors import fpn_anchors
from mmt_psm_tpu_torch.structures import Proposals

U.setup_torch()

STRIDES, SIZES, RATIOS = (4, 8, 16, 32, 64), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)


@pytest.fixture(scope="module")
def pair():
    jm, params, tm, flat = U.build_pair(**U.TRAIN_SMALL)
    return {"jm": jm, "params": params, "tm": tm, "flat": flat, "batch": U.train_batch()}


def _grads_close(got, want, what):
    """Gradients: 1e-4 of the largest |JAX gradient| + 1e-7."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    U.assert_close(got, want, atol=1e-4 * float(np.abs(want).max()) + 1e-7, what=what)


def _rpn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    obj = [rng.normal(0, 2, (2, 128 // s, 128 // s, 3)).astype(np.float32) for s in STRIDES]
    reg = [rng.normal(0, 0.3, (2, 128 // s, 128 // s, 12)).astype(np.float32) for s in STRIDES]
    return obj, reg


def test_rpn_loss_and_gradients(pair, monkeypatch):
    """Anchors matched at 0.7/0.3 with low-quality matches, straddling
    anchors ignored, 256 sampled per image at half positives."""
    U.same_draws(monkeypatch, batch=2)
    obj, reg = _rpn_inputs()
    b = pair["batch"]
    janchors = [jnp.asarray(a) for a in jfpn_anchors(128, STRIDES, SIZES, RATIOS)]

    def jloss(o, r):
        return jrpn.rpn_loss(jax.random.PRNGKey(0), o, r, janchors, jnp.asarray(b["image_size"]), U.jax_gt(b))

    want, (jg_obj, jg_reg) = jax.value_and_grad(lambda o, r: sum(jloss(o, r)), argnums=(0, 1))(obj, reg)
    parts = jloss(obj, reg)

    to = [U.t(x).requires_grad_() for x in obj]
    tr = [U.t(x).requires_grad_() for x in reg]
    from mmt_psm_tpu_torch.ops import sampler

    draws = sampler.uniform(None, (2, sum(a.shape[0] for a in janchors)), "cpu")
    got = rpn.rpn_loss(draws, to, tr, [torch.from_numpy(a) for a in fpn_anchors(128, STRIDES, SIZES, RATIOS)],
                       U.t(b["image_size"]), U.torch_gt(b))
    for g, w, name in zip(got, parts, ("objectness", "box")):
        U.assert_close(g.detach(), w, atol=0.0, rtol=1e-5, what=name)
    sum(got).backward()
    for t, w in zip(to + tr, list(jg_obj) + list(jg_reg)):
        _grads_close(t.grad, w, "rpn input gradient")
    assert float(want) > 0


def test_select_proposals_train_mode():
    """The top FPN_POST_NMS_TOP_N_TRAIN over the whole batch (the
    reference's quirk: it counts per batch), compacted per image, then the
    gt boxes appended with score 1."""
    obj, reg = _rpn_inputs(1)
    b = U.train_batch(seed=1)
    kw = dict(pre_nms_top_n=64, post_nms_top_n=64, fpn_post_nms_top_n=100, nms_thresh=0.7, min_size=0.0)
    janchors = [jnp.asarray(a) for a in jfpn_anchors(128, STRIDES, SIZES, RATIOS)]
    want = jrpn.select_proposals([jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg], janchors,
                                 jnp.asarray(b["image_size"]), is_train=True, gt=U.jax_gt(b), **kw)
    got = rpn.select_proposals([U.t(o) for o in obj], [U.t(r) for r in reg],
                               [torch.from_numpy(a) for a in fpn_anchors(128, STRIDES, SIZES, RATIOS)],
                               U.t(b["image_size"]), is_train=True, gt=U.torch_gt(b), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    U.assert_close(got.boxes, want.boxes, atol=1e-4, what="proposal boxes")
    U.assert_close(got.scores, want.scores, atol=1e-6, what="proposal scores")
    assert got.boxes.shape == (2, 100 + U.MAX_GT, 4)
    # 100 over the batch, not per image
    assert int(got.valid[:, :100].sum()) == 100 and (got.valid[:, :100].sum(1) < 100).all()
    np.testing.assert_array_equal(got.boxes[:, 100:].numpy(), b["boxes"])


def test_box_head_sampling_and_loss(pair, monkeypatch):
    U.same_draws(monkeypatch, batch=2)
    b = pair["batch"]
    rng = np.random.default_rng(2)
    gt_boxes = b["boxes"]
    # proposals around the gt (positives), elsewhere (negatives), padding
    near = gt_boxes[:, rng.integers(0, U.MAX_GT, 40)] + rng.normal(0, 4, (2, 40, 4)).astype(np.float32)
    far = np.concatenate([rng.uniform(0, 90, (2, 40, 2)), rng.uniform(100, 127, (2, 40, 2))], -1).astype(np.float32)
    boxes = np.concatenate([near, far], 1)
    valid = rng.uniform(size=(2, 80)) > 0.1
    jprops = JProposals(boxes=jnp.asarray(boxes), scores=jnp.ones((2, 80)), valid=jnp.asarray(valid))
    kw = dict(batch_size_per_image=64, positive_fraction=0.25, fg_thresh=0.5, bg_thresh=0.5,
              reg_weights=(10.0, 10.0, 5.0, 5.0))
    want = jbh.subsample_proposals(jax.random.PRNGKey(0), jprops, U.jax_gt(b), **kw)
    from mmt_psm_tpu_torch.ops import sampler

    draws = sampler.uniform(None, (2, 80), "cpu")
    got = bh.subsample_proposals(draws, Proposals(boxes=U.t(boxes), scores=torch.ones(2, 80), valid=U.t(valid)),
                                 U.torch_gt(b), **kw)
    for k in ("boxes", "labels", "is_pos", "valid", "matched_gt"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    U.assert_close(got.reg_targets, want.reg_targets, atol=1e-5, rtol=1e-5, what="regression targets")
    assert 0 < int(got.is_pos.sum()) <= 2 * 16

    logits = rng.normal(0, 1, (2, 64, 3)).astype(np.float32)
    regs = rng.normal(0, 0.5, (2, 64, 12)).astype(np.float32)
    jvals = jbh.box_head_loss(logits, regs, want)
    jg = jax.grad(lambda lo, re: sum(jbh.box_head_loss(lo, re, want)), argnums=(0, 1))(logits, regs)
    tl, treg = U.t(logits).requires_grad_(), U.t(regs).requires_grad_()
    vals = bh.box_head_loss(tl, treg, got)
    for g, w, name in zip(vals, jvals, ("classifier", "box_reg")):
        U.assert_close(g.detach(), w, atol=0.0, rtol=1e-5, what=name)
    sum(vals).backward()
    _grads_close(tl.grad, jg[0], "class logits gradient")
    _grads_close(treg.grad, jg[1], "box deltas gradient")


def test_mask_targets_and_loss(pair):
    """The first MASK_MAX_POS positives of each image, their gt masks
    cropped by ROIAlign at the output resolution and thresholded at 0.5
    (identical targets), and the BCE of the gt class's channel."""
    b = pair["batch"]
    rng = np.random.default_rng(3)
    s = 64
    is_pos = rng.uniform(size=(2, s)) < 0.4
    matched = rng.integers(0, U.MAX_GT, (2, s)).astype(np.int32)
    labels = np.where(is_pos, np.take_along_axis(b["labels"], matched, 1), 0).astype(np.int32)
    boxes = np.take_along_axis(b["boxes"], matched[..., None], 1) + rng.normal(0, 3, (2, s, 4)).astype(np.float32)
    rois = jbh.SampledRoIs(boxes=jnp.asarray(boxes), labels=jnp.asarray(labels), reg_targets=jnp.zeros((2, s, 4)),
                           is_pos=jnp.asarray(is_pos), valid=jnp.ones((2, s), bool), matched_gt=jnp.asarray(matched))
    want = jmh.select_positive_rois(rois, 16)
    got = mh.select_positive_rois(bh.SampledRoIs(*(U.t(x) for x in rois)), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m_boxes, m_labels, m_idx, m_valid = want

    jt = jax.vmap(lambda masks, idx, bx: jmh.crop_masks_to_boxes(masks[idx], bx, 28))(
        jnp.asarray(b["masks"]), m_idx, m_boxes)
    tt = mh.crop_masks_to_boxes(U.t(b["masks"]), U.t(m_idx), U.t(m_boxes), 28)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert 0 < float(tt.mean()) < 1

    logits = rng.normal(0, 2, (2, 16, 28, 28, 3)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda lo: jmh.mask_head_loss(lo, jt, m_labels, m_valid))(logits)
    tl = U.t(logits).requires_grad_()
    v = mh.mask_head_loss(tl, tt, U.t(m_labels), U.t(m_valid))
    U.assert_close(v.detach(), jv, atol=0.0, rtol=1e-5, what="mask loss")
    v.backward()
    _grads_close(tl.grad, jg, "mask logits gradient")


def _relation_inputs(batch, seed=4):
    rng = np.random.default_rng(seed)
    s = 64
    feats = rng.normal(0, 1, (2, s, 1024)).astype(np.float32)
    logits = rng.normal(0, 1, (2, s, 3)).astype(np.float32)
    regs = rng.normal(0, 0.5, (2, s, 12)).astype(np.float32)
    idx = rng.integers(0, 4, (2, s))
    boxes = np.take_along_axis(batch["boxes"], idx[..., None], 1) + rng.normal(0, 3, (2, s, 4))
    boxes = np.concatenate([np.minimum(boxes[..., :2], boxes[..., 2:]), np.maximum(boxes[..., :2], boxes[..., 2:]) + 2],
                           -1).clip(0, 127).astype(np.float32)
    return feats, logits, regs, boxes, rng.uniform(size=(2, s)) > 0.1


@pytest.mark.parametrize("reg_iou", [True, False])
def test_relation_nms_loss(pair, reg_iou):
    """The loss of the JAX head's outputs: each gt's best-scoring box over
    the threshold is the target (its IoU with REG_IOU, MSE; else 1, BCE on
    score x logit). With REG_IOU the targets carry gradient into the
    sorted boxes, as in the JAX graph."""
    import dataclasses

    b = pair["batch"]
    jcfg = dataclasses.replace(pair["jm"].config.relation, reg_iou=reg_iou)
    tcfg = dataclasses.replace(pair["tm"].config.relation, reg_iou=reg_iou)
    feats, logits, regs, boxes, valid = _relation_inputs(b)
    jm = dataclasses.replace(pair["jm"].config, relation=jcfg)
    out = JM(config=jm).apply(pair["params"], feats, jax.nn.softmax(logits, -1), regs, boxes, valid,
                              b["image_size"], method=lambda m, *a: m.relation_nms(*a))
    gt = (jnp.asarray(b["boxes"]), jnp.asarray(b["labels"]), jnp.asarray(b["gt_valid"]))

    def jloss(lg, sb, sc):
        o = dict(out, logits=lg, sorted_boxes=sb, sorted_scores=sc)
        return jnp.mean(jax.vmap(functools.partial(jrel.relation_nms_loss, cfg=jcfg))(o, *gt))

    args = (out["logits"], out["sorted_boxes"], out["sorted_scores"])
    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*args)
    t_out = {k: U.t(v) for k, v in out.items()}
    leaves = [U.t(a).requires_grad_() for a in args]
    t_out.update(logits=leaves[0], sorted_boxes=leaves[1], sorted_scores=leaves[2])
    v = rel.relation_nms_loss(t_out, *(U.t(x) for x in gt), tcfg)
    U.assert_close(v.detach(), jv, atol=0.0, rtol=1e-5, what="nms loss")
    v.backward()
    for t, w, name in zip(leaves, jg, ("logits", "sorted boxes", "sorted scores")):
        _grads_close(t.grad, w, name)
    assert (np.abs(np.asarray(jg[1])).max() > 0) == reg_iou  # the IoU targets' gradient

    labels = rel.prepare_nms_labels(t_out["sorted_boxes"], t_out["sorted_scores"], *(U.t(x) for x in gt),
                                    tcfg.threshs, reg_iou)
    jl = jax.vmap(lambda sb, sc, gb, gl, gv: jrel.prepare_nms_labels(sb, sc, gb, gl, gv, jcfg.threshs, reg_iou))(
        out["sorted_boxes"], out["sorted_scores"], *gt)
    U.assert_close(labels.detach(), jl, atol=1e-6, what="targets")
    assert float(labels.detach().sum()) > 0


def test_relation_head_gradients(pair):
    """The head and its loss from the same inputs: gradients of its
    parameters and of the box head's outputs it takes live (fc7 features,
    box deltas) within 1e-3 of their max. The test's WG bias (5) keeps the
    geometric gate log(max(relu(.), 1e-6)) away from its pole, where
    float32 noise would give the two packages different attention."""
    b = pair["batch"]
    flat = dict(pair["flat"])
    flat["relation_nms/relation_module/WG.bias"] = np.full_like(flat["relation_nms/relation_module/WG.bias"], 5.0)
    params = {"params": U.unflatten(flat)}
    from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

    tm = U.MaskRCNN(pair["tm"].config)
    load_jax_params(tm, flat)
    feats, logits, regs, boxes, valid = _relation_inputs(b, seed=5)
    jcfg = pair["jm"].config.relation
    gt = (jnp.asarray(b["boxes"]), jnp.asarray(b["labels"]), jnp.asarray(b["gt_valid"]))

    def jloss(p, f, r):
        out = pair["jm"].apply(p, f, jax.nn.softmax(logits, -1), r, boxes, valid, b["image_size"],
                               method=lambda m, *a: m.relation_nms(*a))
        return jnp.mean(jax.vmap(functools.partial(jrel.relation_nms_loss, cfg=jcfg))(out, *gt))

    jv, (jgp, jgf, jgr) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(params, feats, regs)
    tf, tr = U.t(feats).requires_grad_(), U.t(regs).requires_grad_()
    out = tm.relation_nms(tf, torch.softmax(U.t(logits), -1), tr, U.t(boxes), U.t(valid), U.t(b["image_size"]))
    v = rel.relation_nms_loss(out, *(U.t(x) for x in gt), tm.config.relation)
    U.assert_close(v.detach(), jv, atol=0.0, rtol=1e-5, what="nms loss")
    v.backward()
    U.assert_close(tf.grad, jgf, atol=1e-3 * float(np.abs(np.asarray(jgf)).max()), what="fc7 gradient")
    U.assert_close(tr.grad, jgr, atol=1e-3 * float(np.abs(np.asarray(jgr)).max()), what="box deltas gradient")
    flat_g = U.flatten(jax.tree_util.tree_map(np.asarray, jgp["params"]))
    for name, p in tm.relation_nms.named_parameters():
        want = U.port_grad_of("relation_nms." + name, flat_g)
        U.assert_close(p.grad, want, atol=1e-3 * float(np.abs(want).max()) + 1e-7, what=name)


def test_ciam_under_autograd(pair):
    """CIAM refinement and the deep-supervised mask loss 0.5 (L1 + L2):
    value and gradients of the mask features, first-pass logits and the
    module's parameters (no in-place op on a tensor autograd saved)."""
    b = pair["batch"]
    rng = np.random.default_rng(6)
    s = 16
    feats = rng.normal(0, 1, (2, s, 14, 14, 256)).astype(np.float32)
    logits = rng.normal(0, 2, (2, s, 28, 28, 3)).astype(np.float32)
    labels = rng.integers(1, 3, (2, s)).astype(np.int32)
    valid = rng.uniform(size=(2, s)) > 0.2
    targets = (rng.uniform(size=(2, s, 28, 28)) > 0.5).astype(np.float32)

    def jloss(p, f, lg):
        refined = pair["jm"].apply(p, lg, f, labels, valid, method=JM._refine_masks)
        return 0.5 * (jmh.mask_head_loss(lg, targets, labels, valid) + jmh.mask_head_loss(refined, targets, labels, valid))

    jv, (jgp, jgf, jgl) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(pair["params"], feats, logits)
    tm = pair["tm"]
    tm.zero_grad()
    tf, tl = U.t(feats).requires_grad_(), U.t(logits).requires_grad_()
    ciam = tm.roi_heads.mask.mask_relation_module
    refined = ciam(tf, tl, U.t(labels), U.t(valid))
    tt, tlab, tval = U.t(targets), U.t(labels), U.t(valid)
    v = 0.5 * (mh.mask_head_loss(tl, tt, tlab, tval) + mh.mask_head_loss(refined, tt, tlab, tval))
    U.assert_close(v.detach(), jv, atol=0.0, rtol=1e-5, what="deep-supervised mask loss")
    v.backward()
    _grads_close(tf.grad, jgf, "mask features gradient")
    _grads_close(tl.grad, jgl, "first-pass logits gradient")
    flat_g = U.flatten(jax.tree_util.tree_map(np.asarray, jgp["params"]))
    checked = 0
    for name, p in ciam.named_parameters():
        full = "roi_heads.mask.mask_relation_module." + name
        want = U.port_grad_of(full, flat_g)
        U.assert_close(p.grad, want, atol=1e-4 * float(np.abs(want).max()) + 1e-7, what=full)
        checked += 1
    assert checked >= 8
