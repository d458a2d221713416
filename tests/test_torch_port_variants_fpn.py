"""The plain Mask R-CNN R-50-FPN (``mask_rcnn_fpn``: the flagship without
its IR-Net heads, so the greedy box post-processor) and the flagship with
backbone recomputation (``remat``) against the JAX package.

Both packages build each graph from the same config tree at a 128 canvas
in float32 on the CPU with one set of weights
(``torch_port_variants.variant_pair``):

* ``forward_test``: ``valid`` and ``labels`` identical, boxes, scores and
  mask probabilities within 5e-3;
* ``forward_train`` with the same sampler draws
  (``torch_port_util.same_draws``): the losses within 1e-4 relative, every
  trainable parameter's gradient within 1e-3 of its largest |JAX
  gradient| + 1e-6, or within JAX's own spread where that is larger (the
  largest difference between two JAX runs on the image and on five copies
  with 1e-5 relative noise, ``torch_port_variants.NOISE``); the
  post-processor's NMS is one K1 launch for every (image, class) problem;
* ``remat``: ``torch.utils.checkpoint`` changes no gradient of the
  flagship's train step (the JAX ``nn.remat`` changes none either,
  tests/test_remat.py), and its forward is the flagship's.
"""

import dataclasses

import pytest
import torch

import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu_torch.models import MaskRCNN
from mmt_psm_tpu_torch.ops import nms as N

U.setup_torch()


@pytest.fixture(scope="module")
def fpn():
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, params, tm, _ = V.variant_pair("mask_rcnn_fpn")
        out = {"tm": tm, "want": V.jax_forward_test(jm, params)}
        calls = []
        real = N.suppress_plain
        mp.setattr(N, "suppress_plain", lambda b, v, t: calls.append(tuple(b.shape)) or real(b, v, t))
        out["got"] = V.port_forward_test(tm)
        out["nms_calls"] = calls
        mp.undo()
        U.same_draws(mp, batch=2)
        out["run"] = V.train_run(jm, params, tm)
    return out


def test_mask_rcnn_fpn_forward_test_matches_jax(fpn):
    got, c = fpn["got"], fpn["tm"].config
    assert not c.with_relation_nms and not c.with_relation_mask and c.nms_type == "greedy"
    assert got.boxes.shape == (2, c.detections_per_img, 4) and got.masks.shape == (2, c.detections_per_img, 28, 28)
    V.assert_detections_match(got, fpn["want"])
    # both classes among the detections: the global top-k ranks across classes
    assert set(got.labels[got.valid].tolist()) == {1, 2}


def test_greedy_postprocess_is_one_nms_launch(fpn):
    """The RPN's NMS, then one call over all B x (C - 1) = 4 per-class
    problems of 64 proposals (never a Python loop over classes)."""
    assert fpn["nms_calls"] == [(10, 64, 4), (4, 64, 4)]


def test_mask_rcnn_fpn_losses_match_jax(fpn):
    run = fpn["run"]
    assert sorted(run["losses"]) == ["loss_box_reg", "loss_classifier", "loss_mask", "loss_objectness",
                                     "loss_rpn_box_reg"]  # no nms_loss without relation-NMS
    V.assert_losses_match(run)


def test_mask_rcnn_fpn_gradients_match_jax(fpn):
    by_spread = V.assert_grads_match(fpn["tm"], fpn["run"])
    assert len(by_spread) <= 4, by_spread


def _flagship_step(remat: bool, state=None):
    """The flagship's train step, with and without recomputation."""
    tm = MaskRCNN(dataclasses.replace(V.variant_configs("remat")[1], remat_backbone=remat))
    if state is None:
        tm.init_weights(torch.Generator().manual_seed(0))
    else:
        tm.load_state_dict(state)
    tm.train()
    batch = U.train_batch()
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        losses = tm.forward_train(U.t(batch["image"]), U.t(batch["image_size"]), U.torch_gt(batch),
                                  torch.Generator())
        sum(losses.values()).backward()
    return tm, losses


def test_remat_gradients_equal_the_flagships():
    tm, losses = _flagship_step(True)
    assert tm.config.remat_backbone and tm.backbone.body.remat
    ref, ref_losses = _flagship_step(False, tm.state_dict())
    assert not ref.config.remat_backbone
    for k, v in ref_losses.items():
        assert float(losses[k].detach()) == float(v.detach()), k
    grads = dict(ref.named_parameters())
    n = 0
    for name, p in tm.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.grad, grads[name].grad, rtol=0.0, atol=0.0, msg=name)
            n += 1
    assert n > 100


def test_remat_forward_is_the_flagships():
    tm, _ = _flagship_step(True)
    tm.eval()
    ref = MaskRCNN(dataclasses.replace(tm.config, remat_backbone=False))
    ref.load_state_dict(tm.state_dict())
    got, want = V.port_forward_test(tm), V.port_forward_test(ref)
    for name in ("boxes", "scores", "labels", "valid", "masks"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
