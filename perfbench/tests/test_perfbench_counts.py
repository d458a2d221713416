"""The benchmark's counts: model FLOPs against ``FlopCounterMode`` over the
reference's forward at a small canvas and against pinned numbers at the
cells' size, and the kernel roles' bytes and operations against
``chip_smoke.py``'s at the same shapes and on the calls that the
recorders keep from a training step."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from perfbench_small import SERVE_CELLS, TRAIN_CELLS, MT_CELLS, roles_on_the_cpu, small_cell, small_train_cell

from perfbench.counts import kernels as K, roles

# Each count at batch 16 on the configuration of a cell that reads it,
# pinned. These are the integers of the counts before they were one file a
# count, less the mask targets' crop, which the training counts once counted
# as a dense contraction (2 x 28 x 1024^2 + 2 x 28 x 1024 x 28 FLOPs a
# positive, 16 x 128 positives: 123,547,418,624) and now leave out as gather
# work (K4), as they leave out ROIAlign.
PINNED = {
    ("mask_rcnn_fpn", "mmt_psm_r50_fpn"): {
        "backbone": 4479114018816, "rpn_head": 1658383761408, "box_head": 445087744000,
        "relation_nms": 7946321920, "mask_head": 2962969067520, "mask_relation_ciam": 2049757839360},
    ("mask_rcnn_fpn", "mask_rcnn_r50_fpn"): {
        "backbone": 4479114018816, "rpn_head": 1658383761408, "box_head": 445087744000,
        "mask_head": 3292187852800},
    ("mask_rcnn_fpn_train", "mask_rcnn_r50_fpn"): {
        "backbone_forward": 4479114018816, "rpn_head_forward": 1658383761408, "box_head_forward": 227884924928,
        "mask_head_forward": 2107000225792, "backward": 15670234316800},
    ("mmt_psm_train", "mmt_psm_r50_fpn"): {
        "supervised_forward": 9934552121344, "teacher_backbone": 18282602037248,
        "teacher_pseudo_labels": 7124144734208, "teacher_box_head": 2569923461120,
        "student_forward": 4798535434240, "backward": 26916685774848},
}


def _counted_cells() -> dict:
    """(count, configuration) -> batch of every cell, from its files."""
    from perfbench.harness import spec

    out = {}
    for name in SERVE_CELLS + TRAIN_CELLS + MT_CELLS:
        w = spec.workload(name)
        out.setdefault((w.get("flops", spec.config(w["config"])["flops"]), w["config"]), set()).add(w["batch"])
    return out


@pytest.mark.parametrize("name,config", sorted(PINNED))
def test_the_pinned_counts_are_of_cells_at_batch_16(name, config):
    """Each pinned count is one that a cell reads at batch 16; a cell that
    joins later need not be pinned."""
    assert 16 in _counted_cells().get((name, config), ())


@pytest.mark.parametrize("name,config", sorted(PINNED))
def test_counts_at_batch_16_equal_the_pinned(name, config):
    from perfbench.counts.models import count
    from perfbench.harness import spec

    assert count(name, spec.config(config)["model"], 16) == PINNED[name, config]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_flops_equal_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.counts.models import count
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
    by_stage = count(conf["flops"], model, 2)
    assert sum(by_stage.values()) == counter.get_total_flops()
    assert set(by_stage) >= {"backbone", "rpn_head", "box_head", "mask_head"}


@pytest.mark.parametrize("name", TRAIN_CELLS + MT_CELLS)
def test_training_flops_equal_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.counts.models import count
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
    want = sum(count(w["flops"], model, 2).values())
    # the reference crops each positive's full-canvas gt mask to its box by a
    # dense contraction, rows then columns; the program gathers (K4), and the
    # count leaves the crop out with ROIAlign
    r, hm = 2 * model["mask_pooler_resolution"], model["image_size"]
    want += 2 * model["mask_max_pos"] * (2 * r * hm * hm + 2 * r * hm * r)
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

    shapes = [(2, 64 >> i, 64 >> i, 256) for i in range(4)]
    boxes = torch.zeros(2, 512, 4)
    g_numel = 2 * 512 * 7 * 7 * 256
    want_bytes = g_numel * 2 + boxes.numel() * 5 + sum(math.prod(sh) for sh in shapes) * 2
    assert K.k3_roi_align_bwd(shapes, boxes, 7, 2) == (want_bytes, g_numel * 4 * (4 * 2))


def _mask_case(gen, b, s, m, size):
    masks = (torch.rand(b, m, size, size, generator=gen) > 0.5).to(torch.uint8)
    idx = torch.randint(0, m, (b, s), generator=gen)
    return masks, idx, _boxes(gen, b, s, float(size))


@pytest.mark.parametrize("b,s,m,size,res", [(2, 40, 3, 256, 28), (3, 17, 5, 96, 25)], ids=["edge_r28", "edge_r25"])
def test_k4_equals_chip_smoke(b, s, m, size, res):
    """chip_smoke.py counts K4 inline in ``check_mask_targets``; these are its
    terms, with one box over the masks' edge."""
    import chip_smoke

    k4 = roles.role("k4_mask_targets")
    masks, idx, boxes = _mask_case(torch.Generator().manual_seed(4 + res), b, s, m, size)
    boxes[0, 0] = torch.tensor([size - 2.0, size - 2.0, size + 30.0, size + 40.0])
    pixels = b * s * res * res
    want = (chip_smoke.mask_bytes_read(masks, idx, boxes, res) + b * s * (8 + 16) + pixels * 4,
            pixels * (4 * 4 * 2 + 4 * 2))
    assert k4.work(*k4.keep((masks, idx, boxes, res), torch.zeros(b, s, res, res))) == want


# What K1-K3's calls counted before each was a role: ``counts/kernels.py``'s
# functions on the wrapper's own arguments. A role with no entry here is held
# by the checks common to every role alone.
BEFORE_ROLES = {
    "k1_nms": lambda args, out: K.k1_nms(args[0], args[1], out),
    "k2_roi_align": lambda args, out: K.k2_roi_align(
        tuple(tuple(f.shape) for f in args[0]), args[1], tuple(args[2]), args[3], args[4],
        args[0][0].element_size()),
    "k3_roi_align_bwd": lambda args, out: K.k3_roi_align_bwd(
        tuple(tuple(sh) for sh in args[2]), args[1], args[4], args[0].element_size()),
}


@pytest.fixture(scope="module")
def training_step_calls():
    """A supervised step at the CPU's size, its kernel wrappers holding the
    plain versions: (the recorders' calls, every call's raw arguments and
    output), by role."""
    from perfbench.harness import recorders
    from perfbench.paths import train

    w, conf, mix = small_train_cell(TRAIN_CELLS[0])
    run = train.Run(w, conf, mix, 2**31 + 5, torch.device("cpu"), 0.0)
    run.tr = run.trainer()
    run.pool = run.make_pool()
    raw = {}
    with roles_on_the_cpu(raw), recorders.kernel_calls() as calls:
        run.call(run.tr, run.feed(0))
    return calls, raw


def test_every_role_records_a_training_step(training_step_calls):
    """Every role is wrapped, and each whose roofline the training cell
    reads records calls."""
    from perfbench.harness import spec

    calls, raw = training_step_calls
    assert set(calls) == set(raw) == set(roles.names())
    read = {m["count"] for m in spec.per_layer(TRAIN_CELLS[0]).values() if m["reader"] == "roofline"}
    assert read and read <= {name for name, kept in calls.items() if kept}


@pytest.mark.parametrize("name", roles.names())
def test_role_counts_a_training_steps_calls(training_step_calls, name):
    """Each of the role's calls in the step is recorded once, and its
    (bytes, operations) from what the call kept are positive and what the
    count read from the call's arguments before the role was a file."""
    calls, raw = training_step_calls
    role = roles.role(name)
    assert len(calls[name]) == len(raw[name])
    for (args, out), kept in zip(raw[name], calls[name]):
        got = role.work(*kept)
        assert got == role.work(*role.keep(args, out)) and got[0] > 0 and got[1] > 0
        if name in BEFORE_ROLES:
            assert got == BEFORE_ROLES[name](args, out)
