"""The mean teacher's pure functions in the port against the JAX package's.

The same numpy inputs, made from a seed, go through each JAX function and
its port, in float32 on the CPU: the ramps, the loss weighting with the
reference's rampdown quirk, the EMA rule, ``hflip_boxes``,
``paste_integral``, PSM (and its gradient), MGD, the ODKD/FFI/naive hint
losses and the two canvases. Tolerance: 1e-6 absolute on values of about
1 (the same float32 arithmetic, sums taken in another order), stated per
test; boxes, flips and canvas counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.ops import paste as jpaste
from mmt_psm_tpu.structures.boxes import hflip_boxes as j_hflip_boxes
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu.train.ema import ema_update as j_ema_update
from mmt_psm_tpu.utils import ramp as jramp
from mmt_psm_tpu_torch.ops import paste as paste_mod
from mmt_psm_tpu_torch.ops.paste import paste_integral
from mmt_psm_tpu_torch.structures.boxes import hflip_boxes
from mmt_psm_tpu_torch.train import mt_step as P
from mmt_psm_tpu_torch.train.ema import ema_update_
from mmt_psm_tpu_torch.utils import ramp

U.setup_torch()
ATOL = 1e-6


def _cfgs(**kw):
    return J.MTConfig(**kw), P.MTConfig(**kw)


@pytest.mark.parametrize("name", ["sigmoid_rampup", "sigmoid_rampdown", "linear_rampup", "cosine_rampdown"])
@pytest.mark.parametrize("length", [250, 1000])
def test_ramps_match_jax(name, length):
    """Over a grid of steps before, inside and past the ramp (rampdown's
    phase unclipped: past its length it rises again, as in JAX)."""
    steps = np.arange(-40, 2 * length + 60, 7, dtype=np.float32)
    want = np.asarray(getattr(jramp, name)(jnp.asarray(steps), length))
    got = getattr(ramp, name)(steps, length)
    assert got.dtype == np.float32
    U.assert_close(got, want, atol=ATOL, what=name)
    if name != "cosine_rampdown":
        assert getattr(ramp, name)(5.0, 0) == getattr(jramp, name)(5.0, 0) == 1.0


STEPS = [0, 999, 1000, 1001, 1100, 1249, 1250, 1251, 3000, 6000, 6749, 6750, 6751, 6900, 6999, 7000, 7200]


@pytest.mark.parametrize("rampdown", [250, 1000])
def test_loss_weight_and_sum_match_jax(rampdown):
    """Around START_MT, inside the ramp-up, on the plateau and inside the
    ramp-down, where the reference calls rampdown with the ramp-up length:
    with RAMPDOWN_STEP 1000 the window opens at 6000 but the curve is the
    250-step one (the quirk, in both packages)."""
    jm, pm = _cfgs(start_mt=1000, max_iter=7000, rampup_step=250, rampdown_step=rampdown, lambda_=5.0,
                   cls_loss_weight=0.2, fg_hint=1.0, nms_loss_weight=0.7)
    rng = np.random.default_rng(0)
    keys = ["loss_classifier", "nms_loss", "loss_mask", "mt_classifier", "mt_fg_loss", "mt_hint_loss"]
    losses = {k: np.float32(rng.uniform(0.1, 3.0)) for k in keys}
    for step in STEPS:
        want = float(J.mt_loss_weight(jnp.asarray(step, jnp.int32), jm))
        got = P.mt_loss_weight(step, pm)
        assert isinstance(got, np.float32)
        U.assert_close(got, want, atol=ATOL, what=f"weight at {step}")
        jw = J.weight_sum_losses({k: jnp.asarray(v) for k, v in losses.items()}, jnp.asarray(step, jnp.int32), jm)
        pw = P.weight_sum_losses({k: torch.tensor(v) for k, v in losses.items()}, step, pm)
        assert list(pw) == keys
        for k in keys:
            U.assert_close(pw[k], float(jw[k]), atol=ATOL * 5, what=f"{k} at {step}")
    assert P.mt_loss_weight(1000, pm) == P.mt_loss_weight(3000, pm) == 5.0
    assert 0 < P.mt_loss_weight(1100, pm) < 5.0


@pytest.mark.parametrize("iteration", [0, 1, 9, 1000])
def test_ema_update_matches_jax(iteration):
    """alpha = min(1 - 1/(i+1), ALPHA) in float32; at iteration 0 the teacher
    becomes the student."""
    rng = np.random.default_rng(iteration)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    t = [rng.normal(size=s).astype(np.float32) for s in shapes]
    s = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    want = j_ema_update([jnp.asarray(x) for x in t], [jnp.asarray(x) for x in s], jnp.asarray(iteration), 0.99)
    got = [torch.from_numpy(x.copy()) for x in t]
    ema_update_(got, [torch.from_numpy(x) for x in s], iteration, 0.99)
    for g, w in zip(got, want):
        U.assert_close(g, w, atol=ATOL, what=f"teacher at {iteration}")


def test_hflip_boxes_matches_jax():
    boxes = np.random.default_rng(1).uniform(-10, 140, (3, 20, 4)).astype(np.float32)
    got = hflip_boxes(U.t(boxes), 128)
    U.assert_close(got, j_hflip_boxes(jnp.asarray(boxes), 128), atol=0.0, what="flipped boxes")
    # flipping twice gives the boxes back, up to float32 rounding of 128 - x
    torch.testing.assert_close(hflip_boxes(got, 128), U.t(boxes), atol=2e-5, rtol=0.0)


def _paste_inputs(seed, k=40):
    """28x28 masks with boxes inside, across the border of and off a 64-px
    canvas, a few invalid rows, and one box smaller than a canvas cell."""
    rng = np.random.default_rng(seed)
    masks = rng.uniform(0, 1, (k, 28, 28)).astype(np.float32)
    xy = rng.uniform(-30, 70, (k, 2))
    wh = rng.uniform(1, 50, (k, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[0] = [4.0, 6.0, 60.0, 58.0]  # inside
    boxes[1] = [-20.0, 30.0, 20.0, 90.0]  # across
    boxes[2] = [80.0, 80.0, 120.0, 100.0]  # off
    boxes[3] = [10.2, 10.7, 10.9, 11.1]  # under a cell
    valid = rng.uniform(size=k) > 0.2
    valid[:4] = True
    return masks, boxes, valid


def test_paste_integral_matches_jax(monkeypatch):
    """Per-image canvas counts at stride 4 on a 64-px canvas, identical;
    batched over two images (the JAX package vmaps the per-image call),
    40 RoIs over two chunks, and again over chunks of 7."""
    ins = [_paste_inputs(s) for s in (0, 1)]
    want = np.stack([np.asarray(jpaste.paste_integral(*map(jnp.asarray, x), 16, 4.0)) for x in ins])
    got = paste_integral(*(U.t(np.stack(a)) for a in zip(*ins)), 16, 4.0)
    assert got.shape == (2, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() >= 2 and want.min() == 0  # overlaps and empty cells
    # invalid rows add nothing
    m, b, v = ins[0]
    none = paste_integral(U.t(m), U.t(b), torch.zeros(len(v), dtype=torch.bool), 16, 4.0)
    assert not none.any()
    monkeypatch.setattr(paste_mod, "CHUNK", 7)
    one = paste_integral(*map(U.t, ins[0]), 16, 4.0)  # one image, another chunking
    np.testing.assert_array_equal(one.numpy(), want[0])


def _psm_inputs(seed, n_pos_rows=True):
    """Seven valid positives, so n_pos // 2 = 3 hard negatives are kept; the
    six negatives of largest sigma (rows 10..15 of image 0) are tied, with
    equal logits in each view, so the stable rank picks rows 10, 11 and 12."""
    rng = np.random.default_rng(seed)
    b, s, c = 2, 24, 3
    teacher = [rng.normal(0, 1.5, (b, s, c)).astype(np.float32) for _ in range(4)]
    for i, v in enumerate(teacher):  # confident views that disagree: the largest sigma
        v[0, 10:16] = 12.0 * np.eye(c, dtype=np.float32)[i % c]
    student = [rng.normal(0, 1.5, (b, s, c)).astype(np.float32) for _ in range(2)]
    labels = np.zeros((b, s), np.int32)
    valid = rng.uniform(size=(b, s)) > 0.15
    valid[0, 10:16] = True
    if n_pos_rows:
        labels[1, :7] = rng.integers(1, 3, 7)
        valid[1, :7] = True
    return student, teacher, labels, valid


@pytest.mark.parametrize("case", ["positives", "no_positives", "no_sharpen"])
def test_psm_loss_and_gradient_match_jax(case):
    """Hard negatives by a stable rank of sigma (tied rows included), std
    with ddof 1 over the 4 teacher views, /(n_sel * 3); the gradient w.r.t.
    each student view's logits. Without positives only nothing is selected:
    the loss is 0."""
    student, teacher, labels, valid = _psm_inputs(3, n_pos_rows=case != "no_positives")
    jm, pm = _cfgs(sharpen=case != "no_sharpen")

    def jloss(s):
        return J.psm_loss(s, [jnp.asarray(t) for t in teacher], jnp.asarray(labels), jnp.asarray(valid), jm, 3)

    want, want_g = jax.value_and_grad(jloss)([jnp.asarray(x) for x in student])
    s_t = [U.t(x).requires_grad_() for x in student]
    got = P.psm_loss(s_t, [U.t(t) for t in teacher], U.t(labels), U.t(valid), pm, 3)
    got.backward()
    U.assert_close(got, float(want), atol=ATOL, what="psm loss")
    for g, w in zip(s_t, want_g):
        U.assert_close(g.grad, w, atol=ATOL, what="psm gradient")
    if case == "no_positives":
        assert float(want) == 0.0
    else:
        assert float(want) > 0


def _emb_views(rng, n, b=2, d=8, sizes=(32, 16, 8, 4, 2)):
    return [[rng.normal(size=(b, h, h, d)).astype(np.float32) for h in sizes] for _ in range(n)]


def test_mgd_loss_matches_jax():
    """Five levels (canvas 32 at stride 4 of a 128 canvas, pooled by 1..16),
    4 teacher views and 2 student views, the odd ones flipped back; the
    gradient w.r.t. the student's embeddings too."""
    rng = np.random.default_rng(4)
    t_views, s_views = _emb_views(rng, 4), _emb_views(rng, 2)
    canvas = rng.integers(0, 3, (2, 32, 32)).astype(np.float32)
    canvas[1, :, 20:] = 0
    jm, pm = _cfgs()

    def jloss(s):
        return J.mgd_loss([tuple(map(jnp.asarray, v)) for v in t_views], s, jnp.asarray(canvas), jm)

    want, want_g = jax.value_and_grad(jloss)([tuple(map(jnp.asarray, v)) for v in s_views])
    s_t = [[U.t(x).requires_grad_() for x in v] for v in s_views]
    got = P.mgd_loss([[U.t(x) for x in v] for v in t_views], s_t, U.t(canvas), pm)
    got.backward()
    U.assert_close(got, float(want), atol=ATOL, what="mgd loss")
    for gv, wv in zip(s_t, want_g):
        for g, w in zip(gv, wv):
            U.assert_close(g.grad, w, atol=ATOL, what="mgd gradient")


def test_odkd_ffi_and_naive_hint_losses_match_jax():
    student, teacher, labels, valid = _psm_inputs(5)
    want = J.odkd_loss(jnp.asarray(student[0]), jnp.asarray(teacher[0]), jnp.asarray(labels), jnp.asarray(valid), 1.5)
    got = P.odkd_loss(U.t(student[0]), U.t(teacher[0]), U.t(labels), U.t(valid), 1.5)
    U.assert_close(got, float(want), atol=ATOL, what="odkd")

    rng = np.random.default_rng(6)
    (t0,), (s0,) = _emb_views(rng, 1), _emb_views(rng, 1)
    boxes = np.concatenate([rng.uniform(0, 100, (2, 6, 2)), rng.uniform(100, 128, (2, 6, 2))], -1).astype(np.float32)
    box_valid = rng.uniform(size=(2, 6)) > 0.3
    canvas = np.stack([np.asarray(J.boxes_to_canvas(jnp.asarray(b), jnp.asarray(v), 32, 4.0))
                       for b, v in zip(boxes, box_valid)])
    np.testing.assert_array_equal(P.boxes_to_canvas(U.t(boxes), U.t(box_valid), 32, 4.0).numpy(), canvas)
    assert 0 < canvas.mean() < 1
    want = J.ffi_hint_loss(tuple(map(jnp.asarray, t0)), tuple(map(jnp.asarray, s0)), jnp.asarray(canvas))
    got = P.ffi_hint_loss([U.t(x) for x in t0], [U.t(x) for x in s0], U.t(canvas))
    U.assert_close(got, float(want), atol=ATOL, what="ffi")
    want = J.naive_hint_loss(tuple(map(jnp.asarray, t0)), tuple(map(jnp.asarray, s0)))
    got = P.naive_hint_loss([U.t(x) for x in t0], [U.t(x) for x in s0])
    U.assert_close(got, float(want), atol=ATOL, what="naive hint")


@pytest.mark.parametrize("mask_size,canvas", [(128, 32), (32, 32), (100, 32)])
def test_gt_integral_canvas_matches_jax(mask_size, canvas):
    rng = np.random.default_rng(mask_size)
    masks = (rng.uniform(size=(2, 5, mask_size, mask_size)) > 0.6).astype(np.uint8)
    valid = np.array([[True, True, False, True, False], [False, True, True, True, True]])
    want = J.gt_integral_canvas(jnp.asarray(masks), jnp.asarray(valid), canvas)
    got = P.gt_integral_canvas(U.t(masks), U.t(valid), canvas)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
