"""The mean-teacher step of the plain Mask R-CNN (``mask_rcnn_fpn`` with the
flagship's MT config) against the JAX package: its teacher labels the
unlabeled views through the greedy box post-processor
(``detections_from_features`` with the view-0 images), then PSM and MGD.

Both packages build the training graph (with the MGD hint adaptor) at a
128 canvas in float32 on the CPU with one set of student weights; the
teacher differs from the student in its hint adaptor; the teacher's RoI
subsampling takes the same draws (``torch_port_util.same_draws``). At the
ramp's plateau (START_MT + RAMPUP_STEP, where the MT losses count LAMBDA
times their weights, as test_torch_port_mt_step.py holds the flagship):

* ``unlabeled_losses`` (PSM, MGD) within 1e-4 relative;
* the gradient of the weighted MT losses w.r.t. every student parameter
  within 1e-3 of its largest |JAX gradient| + 1e-6, or within JAX's own
  spread (``torch_port_variants.assert_grads_match``, the student's images
  noised).
The supervised half of the step is test_torch_port_variants_fpn.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu_torch.data.synthetic import generate_unlabeled_batch
from mmt_psm_tpu_torch.models import MaskRCNN
from mmt_psm_tpu_torch.models.variants import variant_config
from mmt_psm_tpu_torch.train import mt_step as P
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

U.setup_torch()

MT_KEYS = ("mt_classifier", "mt_fg_loss")


@pytest.fixture(scope="module")
def run():
    jmt = J.MTConfig.from_cfg(V.jax_variant_cfg("mask_rcnn_fpn"))
    pmt = P.MTConfig.from_cfg(variant_config("mask_rcnn_fpn"))
    step = jmt.start_mt + jmt.rampup_step
    assert float(J.mt_loss_weight(jnp.asarray(step), jmt)) == jmt.lambda_ == pmt.lambda_
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, _, tm, flat = V.variant_pair("mask_rcnn_fpn", train=True)
        assert tm.config.with_hint_adaptor and not tm.config.with_relation_nms
        flat_t = dict(flat)
        rng = np.random.default_rng(7)
        for k in flat_t:
            if k.startswith("hint_adaptor/"):
                flat_t[k] = (flat[k] + rng.normal(0.0, 0.02, flat[k].shape)).astype(np.float32)
        teacher = MaskRCNN(tm.config)
        load_jax_params(teacher, flat_t)
        teacher.eval().requires_grad_(False)
        ub = generate_unlabeled_batch(5, 2, image_size=128, max_instances=U.MAX_GT)
        t_params = U.unflatten(flat_t)

        def mt_loss(p, s_images):
            unl = {"t_images": jnp.asarray(ub["t_images"]), "s_images": s_images,
                   "image_size": jnp.asarray(ub["image_size"])}
            losses = J.unlabeled_losses(jm, p, t_params, unl, jax.random.PRNGKey(1), jmt)
            weighted = J.weight_sum_losses(losses, jnp.asarray(step, jnp.int32), jmt)
            return sum(weighted[k] for k in MT_KEYS), losses

        grad_fn = jax.jit(jax.value_and_grad(mt_loss, has_aux=True))
        params = U.unflatten(flat)
        (_, j_losses), j_grads = grad_fn(params, ub["s_images"])
        as_np = lambda g: U.flatten(jax.tree_util.tree_map(np.asarray, g))  # noqa: E731
        j_noisy = []
        for seed in range(1, 1 + V.NOISE_DRAWS):
            noisy = ub["s_images"] * (1 + V.NOISE * np.random.default_rng(seed).standard_normal(ub["s_images"].shape))
            j_noisy.append(as_np(grad_fn(params, noisy.astype(np.float32))[1]))

        tm.train()
        dets = teacher.detections_from_features(teacher.backbone_features(U.t(ub["t_images"][:, 0])),
                                                U.t(ub["image_size"]), U.t(ub["t_images"][:, 0]))
        losses = P.unlabeled_losses(tm, teacher, {k: U.t(v) for k, v in ub.items()}, torch.Generator(), pmt)
        weighted = P.weight_sum_losses(losses, step, pmt)
        sum(weighted[k] for k in MT_KEYS).backward()
    return {"tm": tm, "losses": losses, "dets": dets,
            "train": {"losses": {k: losses[k] for k in MT_KEYS}, "j_losses": {k: float(j_losses[k]) for k in MT_KEYS},
                      "j_grads": as_np(j_grads), "j_noisy": j_noisy}}


def test_teacher_labels_through_the_greedy_postprocessor(run):
    d = run["dets"]
    assert d.boxes.shape[1] == run["tm"].config.detections_per_img and int(d.valid.sum()) > 0
    assert d.head_ids is None and d.masks is not None


def test_mt_losses_match_jax(run):
    assert set(run["losses"]) == set(MT_KEYS)
    V.assert_losses_match(run["train"])


def test_mt_gradients_match_jax(run):
    by_spread = V.assert_grads_match(run["tm"], run["train"])
    assert len(by_spread) <= 6, by_spread
