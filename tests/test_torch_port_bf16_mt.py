"""The mean teacher's own stages under bf16 against the JAX package's on
the CPU: the hint adaptor, ``paste_integral`` on a real teacher's masks,
``_pooled_mask``, ``mgd_loss`` with its gradient, ``psm_loss`` with
``sharpen`` and ``hard_neg``, and the whole ``unlabeled_losses`` of the
lift's mt and mgd arms.

The lift's graph with the MGD hint adaptor (``torch_port_lift.lift_configs``)
at a 128 canvas in bf16, its counts cut to ``torch_port_lift.STEP_SMALL``;
the port's seeded init with randomised FrozenBN statistics on both sides, a
teacher whose hint adaptor and box predictor differ from the student's;
one unlabeled batch of two images; the sampler draws of
``torch_port_util.same_draws``; each arm's MT config the tool's
``arm_config`` with ``--sharpen --hard-neg``. One jitted JAX function
computes every stage's inputs and outputs as JAX's ``unlabeled_losses``
does (``mmt_psm_tpu/train/mt_step.py:315-466``), and the port's stage is
fed the JAX stage's own inputs:

* the hint adaptor (``models/detector.py::HintAdaptor``) on JAX's bf16
  pyramids of the 2K teacher views, held as test_torch_port_bf16.py holds
  the flagship's stages (``assert_bf16_close``: 4 bf16 steps of the
  largest |value| at any element, one on average);
* ``paste_integral`` on the masks and boxes of JAX's teacher forward: the
  canvases equal at every pixel but those where a valid RoI's sample lies
  within one bf16 step (2**-8) of the 0.5 threshold, which may flip (the
  first run: 43 of 2,048 canvas pixels so near, none different);
* ``_pooled_mask`` on JAX's canvas, at every level: equal to JAX's pooled
  masks (flax ``avg_pool``, then > 0.5);
* ``mgd_loss`` on JAX's bf16 embeddings and canvas: its value within 1e-5
  relative and its gradient w.r.t. the student's bf16 embeddings within
  ``assert_bf16_close``;
* ``psm_loss`` on JAX's bf16 teacher and student logits and JAX's sampled
  labels: the hard negatives, ranked by the spread of the teacher's views,
  counted where the two packages select differently (bf16 logits make
  equal spreads, and so ties, likelier; the first run: 8 of 41 negatives
  selected, none differently), and the value within 1e-5 relative;
* the teacher's pseudo-labels on each package's own bf16 forward: valid
  in the same slots; at the random init both classes score near a third
  and bf16 reorders near-equal scores, so their labels by slot are counted
  (the first run: 7 of 32 slots hold the other class), which moves PSM's
  loss by 5.6%;
* the whole ``unlabeled_losses`` of the mt and mgd arms, each package on
  its own bf16 forward of the same weights and batch, the teacher's
  pseudo-labels (its detections and masks) JAX's on both sides: each loss
  within ``assert_bf16_close``'s 4 bf16 steps of its value (the first run:
  PSM's 1.3 steps, from hard negatives ranked on each package's own bf16
  teacher logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_lift as PL
import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu.models import MaskRCNN as JM
from mmt_psm_tpu.models import box_head as JBH
from mmt_psm_tpu.ops.paste import paste_integral as j_paste_integral
from mmt_psm_tpu.structures.detections import GroundTruth as JGT
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu_torch.data.synthetic import generate_unlabeled_batch
from mmt_psm_tpu_torch.ops import paste as PP
from mmt_psm_tpu_torch.structures.detections import Detections
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L
from mmt_psm_tpu_torch.train import mt_step as P
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params
from test_torch_port_bf16 import BF16_RTOL, STEPS, assert_bf16_close, t

U.setup_torch()

SIZE = 128
ARGS = L.parse_args(["--sharpen", "--hard-neg", "--device", "cpu"])
ARMS = ("mt", "mgd")


def _mt(arm):
    cfg = L.arm_config(ARGS, arm)
    return J.MTConfig.from_cfg(PL.jax_arm_cfg(cfg)), P.MTConfig.from_cfg(cfg)


@pytest.fixture(scope="module")
def stages():
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, _, tm, flat = V.pair_of(*PL.lift_configs(SIZE, with_hint=True, dtype="bfloat16", **PL.STEP_SMALL))
        flat_t = dict(flat)
        rng = np.random.default_rng(7)
        for k in flat_t:
            if k.startswith(("hint_adaptor/", "box_predictor/")):
                flat_t[k] = (flat[k] + rng.normal(0.0, 0.02, flat[k].shape)).astype(np.float32)
        ub = generate_unlabeled_batch(5, 2, image_size=SIZE, max_instances=U.MAX_GT)
        params, t_params = U.unflatten(flat), U.unflatten(flat_t)
        jmt, pmt = _mt("mt")
        c = jm.config
        canvas, stride = SIZE // jmt.mgd_canvas_stride, float(jmt.mgd_canvas_stride)

        @jax.jit
        def run(params, t_params, t_images, s_images, sizes):
            tv, sv = {"params": t_params}, {"params": params}
            views = []
            for k in range(jmt.aug_k):
                views += [t_images[:, k], J.hflip_image(t_images[:, k])]
            feats = jm.apply(tv, jnp.concatenate(views), method=JM.backbone_features)
            f0 = tuple(f[:2] for f in feats)
            dets = jm.apply(tv, f0, sizes, t_images[:, 0], method=JM.detections_from_features)
            integral = jax.vmap(lambda m, b, v: j_paste_integral(m, b, v, canvas, stride))(
                dets.masks, dets.boxes, dets.valid)
            pseudo = JGT(boxes=dets.boxes, labels=dets.labels, valid=dets.valid)
            props = jm.apply(tv, f0, sizes, pseudo, method=JM.teacher_proposals)
            rois = JBH.subsample_proposals(jax.random.PRNGKey(0), props, pseudo,
                                           batch_size_per_image=c.box_batch_per_image,
                                           positive_fraction=c.box_positive_fraction, fg_thresh=c.box_fg_iou,
                                           bg_thresh=c.box_bg_iou, reg_weights=c.reg_weights)
            flipped = J.hflip_boxes(rois.boxes, c.image_size)
            n_views = 2 * jmt.aug_k
            t_logits = jm.apply(tv, feats, jnp.concatenate([flipped if v % 2 else rois.boxes for v in range(n_views)]),
                                True, method=JM.box_predictions)[0]
            t_embs = jm.apply(tv, feats, method=JM.hint_embeddings)
            s_views = [s_images[:, 0]]
            s_feats = jm.apply(sv, jnp.concatenate(s_views), method=JM.backbone_features)
            s_embs = jm.apply(sv, s_feats, method=JM.hint_embeddings)
            s_logits = jm.apply(sv, s_feats, rois.boxes, True, method=JM.box_predictions)[0]
            batch = {"t_images": t_images, "s_images": s_images, "image_size": sizes}
            losses = {arm: J.unlabeled_losses(jm, params, t_params, batch, jax.random.PRNGKey(1), _mt(arm)[0])
                      for arm in ARMS}
            return {"feats": feats, "dets": dets, "integral": integral, "rois": rois, "t_logits": t_logits,
                    "t_embs": t_embs, "s_embs": s_embs, "s_logits": s_logits, "losses": losses}

        out = run(params, t_params, jnp.asarray(ub["t_images"]), jnp.asarray(ub["s_images"]),
                  jnp.asarray(ub["image_size"]))
        # the port's whole unlabeled_losses on its own bf16 forward
        teacher = U.MaskRCNN(tm.config)
        load_jax_params(teacher, flat_t)
        teacher.eval().requires_grad_(False)
        tm.train()
        batch = {k: U.t(v) for k, v in ub.items()}
        port_losses, port_dets = {}, []
        real = P.GroundTruth

        def spy(**kw):  # the teacher's pseudo-labels
            port_dets.append(kw)
            return real(**kw)

        mp.setattr(P, "GroundTruth", spy)
        with torch.no_grad():
            P.unlabeled_losses(tm, teacher, batch, torch.Generator(), _mt("mgd")[1])
        mp.setattr(P, "GroundTruth", real)
        # the same pseudo-labels: the teacher's detections are JAX's
        d = out["dets"]
        jax_dets = Detections(boxes=t(d.boxes), scores=t(d.scores), labels=t(d.labels), valid=t(d.valid),
                              masks=t(d.masks))
        mp.setattr(teacher, "detections_from_features", lambda *a, **k: jax_dets)
        for arm in ARMS:
            with torch.no_grad():
                port_losses[arm] = P.unlabeled_losses(tm, teacher, batch, torch.Generator(), _mt(arm)[1])
    return {"tm": tm, "teacher": teacher, "jmt": jmt, "pmt": pmt, "out": out, "canvas": canvas, "stride": stride,
            "port_losses": port_losses, "port_dets": port_dets}


def _views(levels, n):
    """Per-level [n * B, ...] JAX arrays -> n views of per-level bf16 tensors."""
    return [[t(f[v * 2:(v + 1) * 2]) for f in levels] for v in range(n)]


def test_hint_adaptor_bf16(stages):
    feats = stages["out"]["feats"]
    with torch.no_grad():
        got = stages["teacher"].hint_embeddings([t(f) for f in feats])
    assert len(got) == len(stages["out"]["t_embs"]) == 5
    for lv, (g, w) in enumerate(zip(got, stages["out"]["t_embs"])):
        assert g.dtype == torch.bfloat16
        assert_bf16_close(g, w, f"hint embedding P{lv + 2}")


def test_paste_integral_on_the_teachers_masks(stages):
    d, canvas, stride = stages["out"]["dets"], stages["canvas"], stages["stride"]
    assert int(np.asarray(d.valid).sum()) > 0
    got = PP.paste_integral(t(d.masks), t(d.boxes), t(d.valid), canvas, stride).numpy()
    want = np.asarray(stages["out"]["integral"])
    assert got.shape == want.shape and want.max() > 0
    # the pixels where a valid RoI's sample lies within one bf16 step of 0.5
    ys = (torch.arange(canvas, dtype=torch.float32) + 0.5) * stride - 0.5
    near = np.zeros(want.shape, bool)
    for b in range(want.shape[0]):
        s = PP._sample(t(d.masks[b]).float(), t(d.boxes[b]).float(), ys, ys).numpy()
        v = np.asarray(d.valid[b])
        near[b] = np.any((np.abs(s - 0.5) <= 2.0**-8) & v[:, None, None], axis=0)
    differ = got != want
    print(f"canvas pixels {want.size}, within a bf16 step of 0.5: {int(near.sum())}, different: {int(differ.sum())}")
    assert not np.any(differ & ~near), np.argwhere(differ & ~near)[:5]


def test_pooled_mask_bf16(stages):
    import flax.linen as nn

    canvas = stages["out"]["integral"]
    for f in stages["out"]["t_embs"]:
        h = f.shape[1]
        factor = canvas.shape[1] // h
        pooled = canvas[..., None]
        if factor > 1:
            pooled = nn.avg_pool(pooled, (factor, factor), strides=(factor, factor))
        want = np.asarray((pooled > 0.5).astype(jnp.float32))  # mmt_psm_tpu/train/mt_step.py:178-188
        got = P._pooled_mask(t(canvas), h).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"level of height {h}")
    assert want.shape[1] == 2 and np.any(got)


def test_mgd_loss_and_gradient_bf16(stages):
    o, jmt, pmt = stages["out"], stages["jmt"], stages["pmt"]
    n_t = 2 * jmt.aug_k
    t_views = [tuple(e[v * 2:(v + 1) * 2] for e in o["t_embs"]) for v in range(n_t)]
    s_views = [tuple(o["s_embs"])]
    assert s_views[0][0].dtype == jnp.bfloat16
    value, grads = jax.value_and_grad(lambda s: J.mgd_loss(t_views, s, o["integral"], jmt))(s_views)
    s = [[t(e).requires_grad_(True) for e in s_views[0]]]
    got = P.mgd_loss(_views(o["t_embs"], n_t), s, t(o["integral"]), pmt)
    got.backward()
    assert float(value) > 0
    U.assert_close(got.detach(), float(value), atol=0.0, rtol=1e-5, what="mgd_loss")
    for lv, (g, w) in enumerate(zip(s[0], grads[0])):
        assert g.grad.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert_bf16_close(g.grad, w, f"mgd gradient P{lv + 2}")


def test_psm_loss_bf16_sharpen_hard_neg(stages, monkeypatch):
    o, jmt, pmt = stages["out"], stages["jmt"], stages["pmt"]
    assert pmt.sharpen and pmt.hard_neg
    n_t = 2 * jmt.aug_k
    t_views = [o["t_logits"][v * 2:(v + 1) * 2] for v in range(n_t)]
    assert t_views[0].dtype == jnp.bfloat16
    rois, c = o["rois"], stages["tm"].config.num_classes
    seen = {}
    real_argsort, real_top_k = jnp.argsort, P.top_k

    def argsort_spy(x, *a, **k):
        seen["jax"] = np.asarray(x)
        return real_argsort(x, *a, **k)

    def top_k_spy(x, k):
        seen["port"] = x.numpy().copy()
        return real_top_k(x, k)

    monkeypatch.setattr(jnp, "argsort", argsort_spy)
    want = float(J.psm_loss([o["s_logits"]], t_views, rois.labels, rois.valid, jmt, c))
    monkeypatch.setattr(P, "top_k", top_k_spy)
    got = P.psm_loss([t(o["s_logits"])], [t(x) for x in t_views], t(rois.labels), t(rois.valid), pmt, c)
    # the hard negatives of each package: the first n_pos // 2 of its ranking
    labels, valid = np.asarray(rois.labels).reshape(-1), np.asarray(rois.valid).reshape(-1)
    n_pos = int(((labels > 0) & valid).sum())
    neg = (labels == 0) & valid
    assert n_pos >= 2 and neg.sum() > n_pos // 2
    picks = {}
    for name, key in (("jax", -seen["jax"]), ("port", seen["port"])):
        order = np.argsort(-key, kind="stable")
        picks[name] = set(order[: n_pos // 2].tolist()) & set(np.flatnonzero(neg).tolist())
    differ = len(picks["jax"] ^ picks["port"])
    print(f"hard negatives: {n_pos // 2} of {int(neg.sum())} negatives, selected differently: {differ}")
    assert differ == 0
    U.assert_close(got, want, atol=0.0, rtol=1e-5, what="psm_loss")


@pytest.mark.parametrize("arm", ARMS)
def test_unlabeled_losses_bf16(stages, arm):
    want = stages["out"]["losses"][arm]
    got = stages["port_losses"][arm]
    assert sorted(got) == sorted(want) == sorted({"mt": ["mt_classifier", "mt_fg_loss"], "mgd": ["mt_fg_loss"]}[arm])
    for k, w in want.items():
        # a scalar: assert_bf16_close's bound at its one element (its mean
        # criterion, one step, is for the many elements of a tensor)
        w, g = float(w), float(got[k])
        assert w > 0 and got[k].dtype == torch.float32, k
        print(f"{arm} {k}: port {g!r}, JAX {w!r}, {abs(g - w) / (BF16_RTOL * w):.3f} bf16 steps")
        assert abs(g - w) <= STEPS * BF16_RTOL * w, (arm, k, g, w)


def test_teachers_pseudo_labels_bf16(stages):
    """The port teacher's own bf16 pseudo-labels against JAX's: valid in the
    same slots; at the random init both classes score near a third and bf16
    reorders near-equal scores, so the labels by slot are counted."""
    d = stages["out"]["dets"]
    (pseudo,) = stages["port_dets"]
    np.testing.assert_array_equal(pseudo["valid"].numpy(), np.asarray(d.valid))
    moved = int((pseudo["labels"].numpy() != np.asarray(d.labels)).sum())
    n = int(np.asarray(d.valid).sum())
    print(f"pseudo-labels {n}, labels that differ by slot: {moved}")
    assert n > 0 and moved < n // 2
