"""The R-50-C4 family (``mask_rcnn_c4``: the config defaults, maskrcnn-
benchmark's C4 graph with masks) and the PRCNN mask head (``prcnn``)
against the JAX package.

Both packages build each graph from the same config tree at a 128 canvas
in float32 on the CPU with one set of weights
(``torch_port_variants.variant_pair``): C4 with 24 proposals, 16 sampled
RoIs and 4 mask RoIs an image (its stage-5 head costs ~1.5 GFLOP a RoI),
PRCNN with 12 detections and 4 mask RoIs (its fusion conv ~1.4 GFLOP).

* ``forward_test``: ``valid`` and ``labels`` identical, boxes, scores and
  masks (14 x 14 for C4, 25 x 25 for PRCNN) within 5e-3; one pooling
  call a level (C4: one stride-16 level of 1024 channels for the box and
  the shared mask head; PRCNN: the box head's four FPN levels, then one
  call for each of the four image scales);
* ``forward_train`` with the same sampler draws: losses within 1e-4
  relative, gradients as in test_torch_port_variants_fpn.py.
"""

import pytest

import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu_torch.ops import pooler as Pm

U.setup_torch()


@pytest.fixture(scope="module", params=["mask_rcnn_c4", "prcnn"])
def run(request):
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        jm, params, tm, _ = V.variant_pair(name)
        out = {"name": name, "tm": tm, "want": V.jax_forward_test(jm, params), "pools": []}
        real = Pm.multilevel_roi_align_plain
        mp.setattr(Pm, "multilevel_roi_align_plain",
                   lambda f, b, s, p, g: out["pools"].append((len(f), tuple(s), f[0].shape[-1], p)) or real(f, b, s, p, g))
        out["got"] = V.port_forward_test(tm)
        mp.undo()
        U.same_draws(mp, batch=2)
        out["train"] = V.train_run(jm, params, tm)
    return out


def test_forward_test_matches_jax(run):
    got, c = run["got"], run["tm"].config
    V.assert_detections_match(got, run["want"])
    if run["name"] == "mask_rcnn_c4":
        assert c.conv_body == "R-50-C4" and c.box_extractor == c.mask_extractor == "ResNet50Conv5ROIFeatureExtractor"
        assert got.masks.shape[-1] == 14 and len(run["tm"].anchors) == 1
        assert run["pools"] == [(1, (1 / 16,), 1024, 14), (1, (1 / 16,), 1024, 14)]
        assert not hasattr(run["tm"].roi_heads.mask, "feature_extractor")  # shares the box head's
    else:
        assert c.mask_extractor == "PRCNNFeatureExtractor" and got.masks.shape[-1] == 25
        assert run["pools"] == [(4, (0.25, 0.125, 0.0625, 0.03125), 256, 7)] + [
            (1, (0.5**i,), 32 * 2**i, 25) for i in range(4)]


def test_losses_match_jax(run):
    V.assert_losses_match(run["train"])
    assert "loss_mask" in run["train"]["losses"] and "nms_loss" not in run["train"]["losses"]


def test_gradients_match_jax(run):
    by_spread = V.assert_grads_match(run["tm"], run["train"])
    assert len(by_spread) <= 4, by_spread
