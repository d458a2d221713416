"""The port's training ops against the JAX package's, on seeded numpy inputs.

Box encoding, the IoU matcher (ties at a gt's best IoU included), the
balanced sampler with the same uniform draws, the losses, the anchor
visibility mask and the synthetic data generator. Discrete outputs must be
identical; float outputs agree to float32 rounding (1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.data import synthetic as jsyn
from mmt_psm_tpu.models.anchors import fpn_anchors as jfpn_anchors
from mmt_psm_tpu.models.anchors import visibility as jvisibility
from mmt_psm_tpu.ops import box_coder as jbc
from mmt_psm_tpu.ops import losses as jL
from mmt_psm_tpu.ops.matcher import match as jmatch
from mmt_psm_tpu.ops.sampler import sample as jsample
from mmt_psm_tpu.structures.boxes import box_iou as jbox_iou
from mmt_psm_tpu_torch.data import synthetic as syn
from mmt_psm_tpu_torch.models.anchors import fpn_anchors, visibility
from mmt_psm_tpu_torch.ops import losses as L
from mmt_psm_tpu_torch.ops.box_coder import encode
from mmt_psm_tpu_torch.ops.matcher import match
from mmt_psm_tpu_torch.ops.sampler import sample
from mmt_psm_tpu_torch.structures import GroundTruth, box_iou

U.setup_torch()


def _boxes(rng, shape, canvas=128.0):
    xy = rng.uniform(-10, canvas, shape + (2,))
    wh = rng.uniform(0, canvas / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_matches_jax(weights):
    """Including padded all-zero rows (width 1) and negative-size rows, whose
    widths the 1e-6 floor keeps finite."""
    rng = np.random.default_rng(1)
    ref, props = _boxes(rng, (3, 50)), _boxes(rng, (3, 50))
    ref[:, :5] = 0.0
    props[:, 5:8] = props[:, 5:8, [2, 3, 0, 1]] - 3.0  # x2 < x1 - 1
    got = encode(torch.from_numpy(ref), torch.from_numpy(props), weights)
    want = jbc.encode(jnp.asarray(ref), jnp.asarray(props), weights)
    assert torch.isfinite(got).all()
    U.assert_close(got, want, atol=1e-6, rtol=1e-6, what="deltas")


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_matches_jax_with_ties(low_quality):
    """Quantised IoUs make many ties: between gts for one prediction (argmax
    takes the first) and between predictions at a gt's best IoU (low-quality
    forcing restores every one of them). Padded gt rows never match."""
    rng = np.random.default_rng(2)
    b, m, n = 3, 7, 200
    quality = (np.floor(rng.uniform(0, 1, (b, m, n)) * 8) / 8).astype(np.float32)
    quality[0, 2, :40] = quality[0, 2].max()  # 40 predictions tied at gt 2's best
    quality[1, :, 10] = 0.5  # every gt tied on one prediction
    valid = rng.uniform(size=(b, m)) > 0.2
    valid[2] = False  # an image without gt
    got = match(torch.from_numpy(quality), torch.from_numpy(valid), 0.7, 0.3, low_quality)
    want = np.stack([jmatch(jnp.asarray(q), jnp.asarray(v), 0.7, 0.3, low_quality) for q, v in zip(quality, valid)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[2] == -1).all()
    if low_quality:
        assert (got[0, :40] >= 0).all()


def test_match_on_box_iou_matches_jax():
    rng = np.random.default_rng(3)
    gt, preds = _boxes(rng, (2, 8)), _boxes(rng, (2, 300))
    valid = np.array([[True] * 6 + [False] * 2, [True] * 8])
    q = box_iou(torch.from_numpy(gt), torch.from_numpy(preds))
    jq = jax.vmap(jbox_iou)(jnp.asarray(gt), jnp.asarray(preds))
    U.assert_close(q, jq, atol=1e-6, what="iou")
    got = match(U.t(jq), torch.from_numpy(valid), 0.5, 0.5)
    want = np.stack([jmatch(a, jnp.asarray(v), 0.5, 0.5) for a, v in zip(jq, valid)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch_size,fraction,n_pos", [(256, 0.5, 30), (256, 0.5, 400), (64, 0.25, 0), (512, 0.25, 9)])
def test_sample_matches_jax_with_same_draws(batch_size, fraction, n_pos):
    """The JAX ``sample`` draws r = uniform(key); fed the same r the port
    takes the same slots: indices, positives and validity identical."""
    rng = np.random.default_rng(batch_size + n_pos)
    b, n = 2, 1000
    labels = np.where(rng.uniform(size=(b, n)) < 0.3, -1, 0).astype(np.int32)
    for i in range(b):
        labels[i, rng.choice(n, n_pos, replace=False)] = rng.integers(1, 3, n_pos)
    keys = jax.random.split(jax.random.PRNGKey(batch_size), b)
    r = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    got = sample(torch.from_numpy(r), torch.from_numpy(labels), batch_size, fraction)
    want = [jsample(k, jnp.asarray(lab), batch_size, fraction) for k, lab in zip(keys, labels)]
    for g, w in zip(got, zip(*want)):
        np.testing.assert_array_equal(g.numpy(), np.stack([np.asarray(x) for x in w]))
    idx, is_pos, valid = got
    assert int(is_pos.sum()) == b * min(n_pos, int(batch_size * fraction))
    assert (torch.gather(torch.from_numpy(labels), 1, idx)[valid] >= 0).all()  # never an ignored item


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    x, y = rng.normal(0, 1, (300, 4)).astype(np.float32), rng.normal(0, 1, (300, 4)).astype(np.float32)
    w = (rng.uniform(size=(300, 1)) > 0.5).astype(np.float32)
    for beta in (1.0 / 9, 1.0):
        U.assert_close(L.smooth_l1_sum(U.t(x), U.t(y), beta, U.t(w)), jL.smooth_l1_sum(x, y, beta, w),
                       atol=0.0, rtol=1e-6, what="smooth_l1_sum")
    logits = rng.normal(0, 3, (300, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 300).astype(np.int32)
    valid = (rng.uniform(size=300) > 0.3).astype(np.float32)
    U.assert_close(L.softmax_ce(U.t(logits), U.t(labels), U.t(valid)), jL.softmax_ce(logits, labels, valid),
                   atol=0.0, rtol=1e-6, what="softmax_ce")
    z, t = rng.normal(0, 20, (500,)).astype(np.float32), (rng.uniform(size=500) > 0.5).astype(np.float32)
    U.assert_close(L.bce_with_logits(U.t(z), U.t(t)).mean(), jL.sigmoid_bce(z, t), atol=0.0, rtol=1e-6,
                   what="bce")


@pytest.mark.parametrize("straddle", [0.0, 5.0, -1.0])
def test_visibility_matches_jax(straddle):
    anchors = np.concatenate(fpn_anchors(128, (4, 8, 16, 32, 64), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)))
    janchors = np.concatenate(jfpn_anchors(128, (4, 8, 16, 32, 64), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)))
    np.testing.assert_array_equal(anchors, janchors)
    sizes = np.array([[128, 128], [100, 90]], np.int32)
    got = visibility(torch.from_numpy(anchors), U.t(sizes[:, 0:1]), U.t(sizes[:, 1:2]), straddle)
    want = np.stack([np.asarray(jvisibility(jnp.asarray(janchors), h, w, straddle)) for h, w in sizes])
    np.testing.assert_array_equal(np.broadcast_to(got.numpy(), want.shape), want)


def test_synthetic_batch_is_the_jax_packages():
    """The port's copy of the data generator makes the same arrays from a
    seed, and ``batch_to_torch`` hands them over normalized."""
    got = syn.generate_batch(5, 3, image_size=96, max_instances=U.MAX_GT)
    want = jsyn.generate_batch(5, 3, image_size=96, max_instances=U.MAX_GT)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["gt_valid"].any(axis=1).all()
    t = syn.batch_to_torch(got, "cpu")
    np.testing.assert_array_equal(t["image"].numpy(), jsyn.normalize_image(want["image"]))
    gt = GroundTruth(boxes=t["boxes"], labels=t["labels"], valid=t["gt_valid"], masks=t["masks"])
    assert gt.masks.dtype == torch.uint8 and gt.masks.shape == (3, U.MAX_GT, 96, 96)
