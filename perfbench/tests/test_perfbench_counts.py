"""The benchmark's counts: model FLOPs against ``FlopCounterMode`` over the
reference's forward at a small canvas, and the kernel roles' bytes and
operations against ``chip_smoke.py``'s at the same shapes."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from perfbench_small import SERVE_CELLS, TRAIN_CELLS, MT_CELLS, small_cell, small_train_cell


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_flops_equal_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.counts.flops import COUNTS
    from perfbench.harness.weights import fill
    from perfbench.reference import serve as RS
    from perfbench.reference.build import reference_model

    _, conf, _ = small_cell(name)
    model = dict(conf["model"], compute_dtype="float32")
    net = fill(reference_model(model, "cpu"), 3, conf["init"]).eval()
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8)
    sizes = torch.tensor([[120, 128], [128, 128]], dtype=torch.int32)
    with FlopCounterMode(display=False) as counter:
        RS.detect(net, images, sizes)
    by_stage = COUNTS[conf["flops"]](model, 2)
    assert sum(by_stage.values()) == counter.get_total_flops()
    assert set(by_stage) >= {"backbone", "rpn_head", "box_head", "mask_head"}


@pytest.mark.parametrize("name", TRAIN_CELLS + MT_CELLS)
def test_training_flops_equal_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.counts.flops import COUNTS
    from perfbench.harness.weights import fill
    from perfbench.reference.build import reference_model, train_cfg, train_model_config
    from perfbench.reference.train.mean_teacher import MTTrainer, teacher_of
    from perfbench.reference.train.mt_step import weight_sum_losses
    from perfbench.reference.train.supervised import batch_to_gt
    from perfbench.traffic import cells

    w, conf, mix = small_train_cell(name)
    cfg = train_cfg(conf, w["train_opts"])
    model = dict(train_model_config(conf, cfg), compute_dtype="float32")
    if model.get("relation_mask"):
        model["relation_mask"] = dict(model["relation_mask"], compute_dtype="float32")
    net = fill(reference_model(model, "cpu"), 3, conf["init"])
    tr = MTTrainer(net, teacher_of(net), cfg, torch.Generator().manual_seed(0))
    tr.iteration = w.get("iteration", 0)
    gen = torch.Generator().manual_seed(1)
    batch = cells.labeled(2, mix, gen, "cpu")
    with FlopCounterMode(display=False) as counter:
        if w["path"] == "mt_train":
            losses = tr.mt_losses(batch, cells.unlabeled(2, mix, gen, "cpu", cfg.MT.AUG_K, cfg.MT.AUG_S))
            total = sum(weight_sum_losses(losses, tr.iteration, tr.mt).values())
        else:
            losses = tr.model.forward_train(batch["image"], batch["image_size"], batch_to_gt(batch), tr.gen)
            total = sum(v.float() for v in losses.values())
        total.backward()
    want = sum(COUNTS[w["flops"]](model, 2).values())
    if model["with_relation_nms"]:
        # FlopCounterMode counts the weight gradient of relation-NMS's grouped
        # 1x1 conv as if it were dense: (groups - 1) x its forward too many
        r = model["relation"]
        n, cf = min(r["first_n"], model["box_batch_per_image"]), r["num_classes"] - 1
        want += (r["group"] - 1) * 2 * 2 * cf * n * r["hid_dim"][2] * r["appearance_dim"]
    assert want == counter.get_total_flops()


def _boxes(gen, b, n, size):
    xy = torch.rand(b, n, 2, generator=gen) * size * 0.8
    wh = 4 + torch.rand(b, n, 2, generator=gen) * size * 0.5
    return torch.cat([xy, (xy + wh).clamp(max=size - 1)], -1)


def _no_timing():
    import chip_smoke

    return mock.patch.multiple(chip_smoke, kernel_ms=lambda fn, kernels: 0.0,
                               cuda_ms=lambda fn, iters=20, warmup=3: 0.0)


def test_k1_equals_chip_smoke():
    import chip_smoke
    from mmt_psm_tpu_torch.ops import nms as N

    from perfbench.counts import kernels as K

    gen = torch.Generator().manual_seed(0)
    cases = []
    for p, n, thr in ((6, 300, 0.7), (4, 90, 0.5)):
        cases.append((f"c{n}", _boxes(gen, p, n, 256.0), torch.rand(p, n, generator=gen),
                      torch.rand(p, n, generator=gen) > 0.1, thr))
    with _no_timing():
        _, want_bytes, want_ops = chip_smoke.time_nms(cases, torch.device("cpu"))
    got_bytes = got_ops = 0
    for _, b, s, v, t in cases:
        order = torch.argsort(-torch.where(v, s, N.NEG_INF), dim=-1, stable=True)
        bs = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
        vs = torch.gather(v, 1, order)
        supp = N.suppress_plain(bs, vs, N._thresholds(t, bs.shape[0], bs.device))
        nb, ops = K.k1_nms(bs, vs, supp)
        got_bytes, got_ops = got_bytes + nb, got_ops + ops
    assert (got_bytes, got_ops) == (want_bytes, want_ops)
    assert K.bound(got_bytes, got_ops) == chip_smoke.bound(want_bytes, want_ops)


def test_k2_equals_chip_smoke():
    import chip_smoke

    from perfbench.counts import kernels as K

    gen = torch.Generator().manual_seed(1)
    scales = (0.25, 0.125, 0.0625, 0.03125)
    feats = [torch.randn(2, 64 >> i, 64 >> i, 256, generator=gen).to(torch.bfloat16) for i in range(4)]
    calls = {"box": (_boxes(gen, 2, 200, 256.0), 7), "mask": (_boxes(gen, 2, 50, 256.0), 14)}
    with _no_timing():
        _, want = chip_smoke.time_roi_align(feats, calls, scales)
    nbytes = ops = 0
    for boxes, p in calls.values():
        assert K.sampled_cells(feats, boxes, scales, p, 2) == chip_smoke.sampled_cells(feats, boxes, scales, p, 2)
        b, o = K.k2_roi_align(tuple(tuple(f.shape) for f in feats), boxes, scales, p, 2, 2)
        nbytes, ops = nbytes + b, ops + o
    assert K.bound(nbytes, ops) == want


def test_k3_counts_chip_smokes_terms():
    """chip_smoke.py counts K3 inline in ``check_roi_align_backward``; these are its terms."""
    import math

    from perfbench.counts import kernels as K

    shapes = [(2, 64 >> i, 64 >> i, 256) for i in range(4)]
    boxes = torch.zeros(2, 512, 4)
    g_numel = 2 * 512 * 7 * 7 * 256
    want_bytes = g_numel * 2 + boxes.numel() * 5 + sum(math.prod(sh) for sh in shapes) * 2
    assert K.k3_roi_align_bwd(shapes, boxes, 7, 2) == (want_bytes, g_numel * 4 * (4 * 2))
