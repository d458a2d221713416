"""The mask relation module's variants in the whole model against the JAX
package: the flagship with CAM and each feature extractor
(``mask_rel_*`` of ``mmt_psm_tpu_torch/models/variants.py``), one with
SAME_PREDICTOR (the refined maps through the mask head's own predictor)
and one without deep supervision.

Both packages build each graph from the same config tree at a 128 canvas
in float32 on the CPU with one set of weights
(``torch_port_variants.variant_pair``, relation-NMS's geometric gate off
its pole):

* ``forward_test`` of every ``mask_rel_*`` variant: ``valid`` and
  ``labels`` identical, boxes, scores and masks within 5e-3;
* ``forward_train`` of SAME_PREDICTOR and of the variant without deep
  supervision, with the same sampler draws: losses within 1e-4 relative,
  gradients as in test_torch_port_variants_fpn.py.
"""

import pytest

import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu_torch.models.variants import VARIANTS

U.setup_torch()

MASK_REL = [n for n in VARIANTS if n.startswith("mask_rel_")]
# the weights of the forward comparison: under flax's truncated lecun_normal
# the seed-0 weights of the MASK_FEATURE and SAME_PREDICTOR variants score no
# detection above the threshold in either package, which compares nothing
FORWARD_SEED = 1


@pytest.mark.parametrize("name", MASK_REL)
def test_forward_test_matches_jax(name):
    jm, params, tm, _ = V.variant_pair(name, seed=FORWARD_SEED)
    c = tm.config
    assert c.with_relation_mask and c.relation_mask.type == "CAM" and c.with_relation_nms
    got = V.port_forward_test(tm)
    V.assert_detections_match(got, V.jax_forward_test(jm, params))
    assert got.masks.shape[-1] == 28


@pytest.mark.parametrize("name", ["mask_rel_same_predictor", "mask_rel_mask_feature"])
def test_train_step_matches_jax(name):
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, params, tm, _ = V.variant_pair(name)
        run = V.train_run(jm, params, tm)
    c = tm.config.relation_mask
    assert (c.same_predictor, c.deep_super) == ((True, True) if name == "mask_rel_same_predictor" else (False, False))
    assert "nms_loss" in run["losses"] and "loss_mask" in run["losses"]
    V.assert_losses_match(run)
    # relation-NMS's box regression gradient is conditioned worse than the
    # strict bound (test_torch_port_train_step.py)
    by_spread = V.assert_grads_match(tm, run)
    assert len(by_spread) <= 6, by_spread
    mod = tm.roi_heads.mask.mask_relation_module
    assert hasattr(mod, "classifier") != c.same_predictor
