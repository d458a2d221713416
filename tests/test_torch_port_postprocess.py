"""The box post-processor without relation-NMS, the host set-NMS and the
K_HEAD > 1 matcher against the JAX package, on random data.

* ``postprocess_boxes`` (JAX ``models/box_head.py:201-273``), "greedy" and
  "set", on random class logits, box deltas and proposals (some invalid,
  some of them with tied scores): ``valid``, ``labels`` and the set path's
  ``head_ids`` identical, boxes and scores within 1e-5;
* ``set_nms_filter``, ``set_cpu_nms``, ``cyto_nms`` and ``cpu_nms``
  (host numpy): identical;
* ``match_topk``: identical;
* ``ShapeBuffer``: the JAX layout and its initialiser's variance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.models import box_head as jbh
from mmt_psm_tpu.models.mask_relation import ShapeBuffer as JShapeBuffer
from mmt_psm_tpu.ops import matcher as jmatcher
from mmt_psm_tpu.ops import python_nms as jpn
from mmt_psm_tpu.structures.detections import Proposals as JProposals
from mmt_psm_tpu_torch.models import box_head as bh
from mmt_psm_tpu_torch.models.mask_relation import ShapeBuffer
from mmt_psm_tpu_torch.ops import matcher, python_nms
from mmt_psm_tpu_torch.ops import nms as N
from mmt_psm_tpu_torch.structures import Proposals
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

U.setup_torch()

B, P, C, K = 2, 48, 3, 20  # images, proposals an image, classes, detections an image


def _inputs(seed: int, ties: bool):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.5, (B, P, C)).astype(np.float32)
    if ties:  # coarse logits: many equal scores within and across classes
        logits = np.round(logits * 2) / 2
    regs = rng.normal(0.0, 0.5, (B, P, 4 * C)).astype(np.float32)
    xy = rng.uniform(-10, 100, (B, P, 2))
    wh = rng.uniform(4, 60, (B, P, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # clusters of near-duplicates, so that NMS suppresses
    boxes[:, 1::3] = boxes[:, 0::3][:, : boxes[:, 1::3].shape[1]] + rng.uniform(-2, 2, boxes[:, 1::3].shape)
    valid = rng.uniform(size=(B, P)) > 0.15
    sizes = np.array([[128, 128], [100, 120]], np.int32)
    return logits, regs, boxes, valid, sizes


def _jax_post(nms_type):
    return jax.jit(lambda lg, rg, bx, v, s: jbh.postprocess_boxes(
        lg, rg, JProposals(boxes=bx, scores=jnp.zeros(v.shape), valid=v), s, num_classes=C,
        score_thresh=0.05, nms_thresh=0.5, detections_per_img=K, nms_type=nms_type))


@pytest.fixture(scope="module")
def jax_post():
    return {t: _jax_post(t) for t in ("greedy", "set")}


@pytest.mark.parametrize("nms_type", ["greedy", "set"])
@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True), (3, True)])
def test_postprocess_matches_jax(jax_post, nms_type, seed, ties):
    logits, regs, boxes, valid, sizes = _inputs(seed, ties)
    want = jax_post[nms_type](logits, regs, boxes, valid, sizes)
    got = bh.postprocess_boxes(U.t(logits), U.t(regs), Proposals(U.t(boxes), torch.zeros(B, P), U.t(valid)),
                               U.t(sizes), num_classes=C, score_thresh=0.05, nms_thresh=0.5,
                               detections_per_img=K, nms_type=nms_type)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32 and got.boxes.shape == (B, K, 4)
    U.assert_close(got.boxes, want.boxes, atol=1e-5, what="boxes")
    U.assert_close(got.scores, want.scores, atol=1e-6, what="scores")
    if nms_type == "set":
        np.testing.assert_array_equal(got.head_ids.numpy(), np.asarray(want.head_ids))
    else:
        assert got.head_ids is None and want.head_ids is None
    assert 0 < int(got.valid.sum()) and set(got.labels[got.valid].tolist()) == {1, 2}


def test_greedy_postprocess_launches_nms_once(monkeypatch):
    """All B x (C - 1) per-class problems, each with its own threshold row,
    in one call of the suppression (K1 on the card)."""
    logits, regs, boxes, valid, sizes = _inputs(0, False)
    calls = []
    real = N.suppress_plain
    monkeypatch.setattr(N, "suppress_plain", lambda b, v, t: calls.append((tuple(b.shape), t.tolist())) or real(b, v, t))
    bh.postprocess_boxes(U.t(logits), U.t(regs), Proposals(U.t(boxes), torch.zeros(B, P), U.t(valid)), U.t(sizes),
                         num_classes=C, detections_per_img=K)
    assert calls == [((B * (C - 1), P, 4), [0.5] * (B * (C - 1)))]


def _dets(seed, n=60):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1).astype(np.float32)
    boxes[1::2] = boxes[0::2] + rng.uniform(-3, 3, boxes[0::2].shape)  # overlapping pairs
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    heads = rng.integers(0, 12, n).astype(np.int32)
    labels = rng.integers(1, 3, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    return boxes, scores, labels, valid, heads


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.0])
def test_set_nms_filter_matches_jax(seed, thr):
    boxes, scores, labels, valid, heads = _dets(seed)
    want = jbh.set_nms_filter(boxes, scores, labels, valid, heads, nms_thresh=thr, num_classes=3)
    got = bh.set_nms_filter(boxes, scores, labels, valid, heads, nms_thresh=thr, num_classes=3)
    np.testing.assert_array_equal(got, want)
    if thr > 0:
        assert got.sum() < valid.sum()  # it suppresses
        assert not (got & ~valid).any()


@pytest.mark.parametrize("seed", range(3))
def test_host_nms_variants_match_jax(seed):
    boxes, scores, _, _, heads = _dets(seed)
    np.testing.assert_array_equal(python_nms.set_cpu_nms(boxes, scores, heads, 0.4),
                                  jpn.set_cpu_nms(boxes, scores, heads, 0.4))
    dets = np.concatenate([boxes, scores[:, None]], 1)
    np.testing.assert_array_equal(python_nms.cpu_nms(dets, 0.4), jpn.cpu_nms(dets, 0.4))
    rng = np.random.default_rng(seed)
    ids = [list(rng.integers(0, 8, rng.integers(0, 4))) for _ in range(len(boxes))]
    np.testing.assert_array_equal(python_nms.cyto_nms(boxes, scores, [list(i) for i in ids], 0.5),
                                  jpn.cyto_nms(boxes, scores, [list(i) for i in ids], 0.5))


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_match_topk_matches_jax(top_k):
    rng = np.random.default_rng(top_k)
    quality = np.round(rng.uniform(0, 1, (6, 40)), 1).astype(np.float32)  # ties between gt
    gt_valid = np.array([True, True, False, True, True, False])
    want = jmatcher.match_topk(jnp.asarray(quality), jnp.asarray(gt_valid), 0.5, 0.3, top_k=top_k)
    got = matcher.match_topk(U.t(quality), U.t(gt_valid), 0.5, 0.3, top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # row 0 is match() without low-quality matches
    np.testing.assert_array_equal(got[0].numpy(), matcher.match(U.t(quality), U.t(gt_valid), 0.5, 0.3).numpy())


def test_shape_buffer_layout_and_init():
    jsb = JShapeBuffer(center_per_class=4, resolution=28)
    j = jsb.init(jax.random.PRNGKey(0))["params"]["center"]
    sb = ShapeBuffer(center_per_class=4, resolution=28)
    assert tuple(sb.center.shape) == tuple(j.shape) == (8, 28, 28, 1)
    sb.init_weights(torch.Generator().manual_seed(0))
    # flax xavier_normal: variance 1 / fan_avg, fans (28 * 8 * 28, 8 * 28) of the [.., in, out] layout
    want_std = (2.0 / (28 * 8 * 28 + 8 * 28)) ** 0.5
    assert abs(float(sb.center.detach().std()) / want_std - 1) < 0.05
    assert abs(float(np.asarray(j).std()) / want_std - 1) < 0.05
    holder = torch.nn.Module()
    holder.shape_buffer = sb
    load_jax_params(holder, {"shape_buffer.center": np.asarray(j)})
    np.testing.assert_array_equal(sb().detach().numpy(), np.asarray(j))
