"""Set-NMS (``set_nms``: K_HEAD 2, NMS_TYPE set) and the RPN-only model
(``rpn_only``) against the JAX package, through ``forward_test`` and the
serving engine.

Both packages build each graph from the same config tree at a 128 canvas
in float32 on the CPU with one set of weights
(``torch_port_variants.variant_pair``), 16 proposals an image after the
RPN:

* ``forward_test``: ``valid``, ``labels`` and set-NMS's ``head_ids``
  identical, boxes, scores and masks within 5e-3; RPN-only detections are
  the proposals by decreasing objectness, label 1, no masks;
* the RPN-only train step: its two losses within 1e-4 relative and every
  gradient as in test_torch_port_variants_fpn.py;
* ``run_inference`` over the windows of a synthetic slide whose gt are the
  JAX model's own instances: the Papeval stats identical to the JAX
  ``run_inference``'s (set-NMS filters each image's detections on the
  host; RPN-only boxes are pasted filled).
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu.data import loader as jloader
from mmt_psm_tpu.data import pap as jpap
from mmt_psm_tpu.engine import inference as jinf
from mmt_psm_tpu.engine import paste as jpaste
from mmt_psm_tpu_torch.data import loader
from mmt_psm_tpu_torch.engine import inference as inf
from mmt_psm_tpu_torch.models import box_head as bh

U.setup_torch()

FPN_POST = 16  # proposals an image after the RPN
EXTRA = {"set_nms": dict(fpn_post_nms_top_n_test=FPN_POST, detections_per_img=24),
         "rpn_only": dict(fpn_post_nms_top_n_test=FPN_POST)}
SLIDES = dict(seed=42, num_slides=1, slide_size=256, win_size=128, overlap=0.0, is_train=False)
LOADER = dict(max_gt=16, min_size=128, max_size=128, raw_u8=True)
BATCH = 3  # 4 windows: batches of 3 and 1 (padded to 3)


@pytest.fixture(scope="module", params=["set_nms", "rpn_only"])
def pair(request):
    jm, params, tm, _ = V.variant_pair(request.param, **EXTRA[request.param])
    return request.param, jm, params, tm


class PseudoGT:
    """The windows of a synthetic slide whose gt are the JAX model's own
    pasted instances (box-filled for a box-only model), every other one
    moved 2 px right (test_torch_port_serving.py's ``PseudoGT``)."""

    def __init__(self, jm, params, ds):
        self.items = []
        for batch in jloader.make_test_loader(ds, BATCH, 128, **LOADER):
            boxes, scores, labels, valid, masks, _ = jax.device_get(
                jinf._cached_infer(jm)(params, batch["image"], batch["image_size"]))
            masks = np.ones(boxes.shape[:2] + (1, 1), np.float32) if masks is None else np.asarray(masks, np.float32)
            for i in range(batch["n_real"]):
                dt = jpaste.detections_to_instseg(boxes[i], scores[i], labels[i], valid[i], masks[i], (128, 128))
                gt_boxes, gt_labels, gt_masks = [], [], []
                for c, inst in sorted(dt.items()):
                    for k, (b, m) in enumerate(zip(inst.boxes, inst.masks)):
                        full = np.zeros((128, 128), np.uint8)
                        full[b[1]:b[3] + 1, b[0]:b[2] + 1] = m
                        if k % 2:
                            full = np.pad(full, ((0, 0), (2, 0)))[:, :128]
                        ys, xs = np.nonzero(full)
                        if len(ys) < 4:
                            continue
                        gt_boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
                        gt_labels.append(c)
                        gt_masks.append(full)
                n = min(len(gt_boxes), LOADER["max_gt"])
                self.items.append({"image": batch["image"][i], "boxes": np.asarray(gt_boxes, np.float32)[:n],
                                   "labels": np.asarray(gt_labels, np.int32)[:n],
                                   "masks": np.asarray(gt_masks, np.uint8)[:n]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_forward_test_matches_jax(pair):
    name, jm, params, tm = pair
    got, want = V.port_forward_test(tm), V.jax_forward_test(jm, params)
    V.assert_detections_match(got, want)
    if name == "rpn_only":
        assert got.masks is None and got.boxes.shape == (2, FPN_POST, 4)
        np.testing.assert_array_equal(got.labels.numpy(), got.valid.numpy().astype(np.int32))
        s = torch.where(got.valid, got.scores, -1.0)
        assert (s[:, :-1] >= s[:, 1:]).all()  # by decreasing objectness
    else:
        assert got.head_ids is not None and int(got.head_ids.max()) < FPN_POST
        assert tm.config.nms_type == "set" and got.masks.shape[-1] == 28


def test_run_inference_matches_jax(pair, monkeypatch):
    name, jm, params, tm = pair
    items = PseudoGT(jm, params, jpap.synthetic_slide_dataset(**SLIDES))
    want, wt = jinf.run_inference(jm, params, jloader.make_test_loader(items, BATCH, 128, **LOADER), eval_workers=0)
    filtered = []
    real = bh.set_nms_filter
    monkeypatch.setattr(inf, "set_nms_filter", lambda *a, **k: filtered.append(1) or real(*a, **k))
    got, timing = inf.run_inference(tm, loader.make_test_loader(items, BATCH, 128, **LOADER), eval_workers=0)
    assert timing["images"] == wt["images"] == 4
    assert len(filtered) == (4 if name == "set_nms" else 0)
    assert got == want
    assert max(got["AJI"].values()) > 0 and got["mAP"]["all"] > 0


def test_rpn_only_train_step_matches_jax():
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, params, tm, _ = V.variant_pair("rpn_only")
        run = V.train_run(jm, params, tm)
    assert sorted(run["losses"]) == ["loss_objectness", "loss_rpn_box_reg"]
    V.assert_losses_match(run)
    by_spread = V.assert_grads_match(tm, run)
    assert len(by_spread) <= 4, by_spread
    # only the backbone and the RPN head train
    assert all(n.startswith(("backbone.", "rpn.", "hint_adaptor.")) for n, _ in tm.named_parameters())
