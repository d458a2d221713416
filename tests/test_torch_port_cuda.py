"""Kernels K1, K2 and K3 on the card against their plain versions.

Marked ``gpu``: each test skips, with its reason, where no CUDA device is
present (the other tests/test_torch_port_*.py hold the plain versions to
the JAX package on the CPU).
On a GPU host: ``python -m pytest tests/test_torch_port_cuda.py -m gpu --noconftest``
(tests/conftest.py imports JAX, which a GPU host need not have).
``chip_smoke.py`` makes the same comparisons at the flagship's shapes.
"""

import math
import os

import pytest
import torch

from chip_smoke import NMS_EDGE_CASES, nms_edge_case, own_instances_as_gt
from mmt_psm_tpu_torch.ops import nms as N
from mmt_psm_tpu_torch.ops import pooler as P

pytestmark = pytest.mark.gpu

SCALES = (0.25, 0.125, 0.0625, 0.03125)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _boxes(gen, shape, canvas, dev):
    wh = 4 + (canvas / 2) * torch.rand(*shape, 2, generator=gen, device=dev) ** 2
    xy = torch.rand(*shape, 2, generator=gen, device=dev) * canvas - 20
    return torch.cat([xy, xy + wh], -1)


@pytest.mark.parametrize("p,n,thr", [(20, 1000, 0.7), (20, 2000, 0.7), (8, 90, 0.55), (3, 130, 0.5), (2, 1, 0.5),
                                     (8, 1000, 0.5), (4, 6000, 0.7), (4, 12000, 0.7)])
def test_nms_kernel_identical_to_plain(dev, p, n, thr):
    gen = torch.Generator(device=dev).manual_seed(n)
    boxes = _boxes(gen, (p, n), 512, dev)
    scores = (torch.rand(p, n, generator=gen, device=dev) * 10).floor()  # ties
    valid = torch.rand(p, n, generator=gen, device=dev) > 0.1
    before = N.suppress_cuda.launches
    got = N.nms_mask(boxes, scores, valid, thr)
    assert N.suppress_cuda.launches == before + 1
    assert torch.equal(got, N.nms_mask_plain(boxes, scores, valid, thr))


@pytest.mark.parametrize("case", list(NMS_EDGE_CASES))
def test_nms_kernel_edge_cases(dev, case):
    """K1 on the cases that stress its block-wise scan (chains that cross
    64-row borders, one box repeated, no overlaps, thresholds 0 and 1, N
    around one word, N = 6000 and 12000): keeps identical to the plain
    version, and to the greedy result where the case's construction gives it."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    boxes, scores, valid, thr, keep = nms_edge_case(case, gen, dev)
    got = N.nms_mask(boxes, scores, valid, thr)
    assert torch.equal(got, N.nms_mask_plain(boxes, scores, valid, thr))
    if keep is not None:
        assert torch.equal(got, keep)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("n,p", [(300, 7), (50, 14)])
def test_roi_align_kernel_matches_plain(dev, dtype, rtol, n, p):
    """f32: 1e-5 abs; bf16: one bf16 rounding of the same f32 sum (2^-7 rel)."""
    gen = torch.Generator(device=dev).manual_seed(p)
    feats = [torch.randn(2, 128 >> i, 128 >> i, 64, generator=gen, device=dev).to(dtype) for i in range(4)]
    boxes = _boxes(gen, (2, n), 512, dev)
    boxes[:, 0] = torch.tensor([-100.0, 200.0, 700.0, 230.0], device=dev)  # far beyond a 48-cell window
    got = P.multilevel_roi_align(feats, boxes, SCALES, p, 2)
    want = P.multilevel_roi_align_plain(feats, boxes, SCALES, p, 2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p", [(300, 7), (50, 14)])
def test_roi_align_backward_kernel_matches_plain(dev, dtype, n, p):
    """K3 against the plain index_add_ transpose. f32: 1e-4 abs, the same
    float32 sums in another order; bf16: that sum rounded once, so at most one
    bf16 step (2^-7 of the largest |gradient|). Half the RoIs come in
    clusters of 10 within 1 px, so they add into the same cells."""
    gen = torch.Generator(device=dev).manual_seed(p + 1)
    shapes = [(2, 128 >> i, 128 >> i, 64) for i in range(4)]
    boxes = _boxes(gen, (2, n), 512, dev)
    m = n - n // 2
    centres = boxes[:, n // 2:n // 2 + m // 10 + 1].repeat_interleave(10, dim=1)[:, :m]
    boxes[:, n // 2:] = centres + torch.rand(2, m, 4, generator=gen, device=dev)
    boxes[:, 0] = torch.tensor([-100.0, 200.0, 700.0, 230.0], device=dev)  # far beyond a 48-cell window
    grad = torch.randn(2, n, p, p, 64, generator=gen, device=dev).to(dtype)
    before = P.multilevel_roi_align_backward_cuda.launches
    got = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, p, 2)
    assert P.multilevel_roi_align_backward_cuda.launches == before + 1
    want = P.multilevel_roi_align_backward_plain(grad, boxes, shapes, SCALES, p, 2)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0.0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("c", [256, 512])
def test_roi_align_kernel_wide_channels(dev, dtype, rtol, c):
    """K2 at the FPN's width and at twice it (a lane owns 8 channels, a
    block loops over 256-channel chunks): f32 1e-5 abs, bf16 one rounding."""
    gen = torch.Generator(device=dev).manual_seed(c)
    feats = [torch.randn(2, 128 >> i, 128 >> i, c, generator=gen, device=dev).to(dtype) for i in range(4)]
    boxes = _boxes(gen, (2, 120), 512, dev)
    for p in (7, 14):
        got = P.multilevel_roi_align(feats, boxes, SCALES, p, 2)
        want = P.multilevel_roi_align_plain(feats, boxes, SCALES, p, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)


def _k3_case(gen, case, dev):
    """Boxes [1, n, 4] on a 1024 canvas for one K3 case (levels 256^2 ... 32^2,
    a tile of 4 cells a side spans 16, 32, 64 and 128 px of the canvas at levels 0-3)."""
    if case == "tile_borders":  # level-0 RoIs whose samples straddle tile rows and columns
        k = torch.arange(24, device=dev, dtype=torch.float32)
        x0 = 32.0 * (k % 6 + 1) - 2.0 + 0.25 * (k % 4)
        y0 = 32.0 * (k // 6 + 1) - 1.0
        boxes = torch.stack([x0, y0, x0 + 29.0 + k, y0 + 31.0], -1)
    elif case == "outside":  # partly outside the map, every level
        boxes = torch.tensor([[-40.0, -30.0, 60.0, 50.0], [980.0, 990.0, 1100.0, 1080.0],
                              [-300.0, 400.0, 200.0, 700.0], [700.0, -500.0, 1300.0, 300.0],
                              [-900.0, -900.0, 1900.0, 1900.0]], device=dev)
    elif case == "p5_many_tiles":  # ~32 cells on P5 (8 tiles a side), ~20 on P4
        boxes = torch.tensor([[0.0, 0.0, 1023.0, 1023.0], [10.0, 20.0, 1000.0, 990.0],
                              [100.0, 60.0, 420.0, 380.0]], device=dev)
    else:  # "clustered": 4 clusters of 10 boxes within 1 px, so they share cells
        centres = _boxes(gen, (1, 4), 1024, dev)
        boxes = centres.repeat_interleave(10, dim=1)[0] + torch.rand(40, 4, generator=gen, device=dev)
    return boxes[None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["tile_borders", "outside", "p5_many_tiles", "clustered", "zero_cotangent"])
def test_roi_align_backward_kernel_cases(dev, dtype, case):
    """K3 against the plain transpose on RoIs that K3's tiles must
    split or drop right (f32 1e-4 abs, bf16 one step); levels that no RoI
    maps to, and an all-zero cotangent, come out all zero."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    shapes = [(1, 256 >> i, 256 >> i, 64) for i in range(4)]
    boxes = _k3_case(gen, "clustered" if case == "zero_cotangent" else case, dev)
    n, p = boxes.shape[1], 7 if case != "clustered" else 14
    grad = torch.randn(1, n, p, p, 64, generator=gen, device=dev).to(dtype)
    if case == "zero_cotangent":
        grad.zero_()
    got = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, p, 2)
    want = P.multilevel_roi_align_backward_plain(grad, boxes, shapes, SCALES, p, 2)
    used = set(P._levels(boxes, SCALES).flatten().tolist())
    for lv, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape
        if lv not in used or case == "zero_cotangent":
            assert not g.any(), f"level {lv} must be all zero"
        atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0.0)
    if case == "tile_borders":
        assert used == {0} and 3 not in used
    if case == "p5_many_tiles":
        assert 3 in used


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_deterministic(dev, dtype):
    """No atomics: two launches on the same inputs give bit-identical gradients."""
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = [(2, 128 >> i, 128 >> i, 256) for i in range(4)]
    boxes = torch.cat([_boxes(gen, (2, 100), 512, dev), _k3_case(gen, "clustered", dev).expand(2, -1, -1) / 2], 1)
    grad = torch.randn(2, boxes.shape[1], 7, 7, 256, generator=gen, device=dev).to(dtype)
    first = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, 7, 2)
    second = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, 7, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_roi_align_autograd_runs_k2_and_k3(dev):
    """Through ``multilevel_roi_align`` the forward launches K2 and the
    backward K3, and the feature gradients equal the plain backward's."""
    gen = torch.Generator(device=dev).manual_seed(9)
    feats = [torch.randn(2, 64 >> i, 64 >> i, 32, generator=gen, device=dev).requires_grad_() for i in range(4)]
    boxes = _boxes(gen, (2, 40), 256, dev)
    k2, k3 = P.multilevel_roi_align_cuda.launches, P.multilevel_roi_align_backward_cuda.launches
    out = P.multilevel_roi_align(feats, boxes, SCALES, 7, 2)
    g = torch.randn(out.shape, generator=gen, device=dev)
    out.backward(g)
    assert (P.multilevel_roi_align_cuda.launches, P.multilevel_roi_align_backward_cuda.launches) == (k2 + 1, k3 + 1)
    want = P.multilevel_roi_align_backward_plain(g, boxes, [f.shape for f in feats], SCALES, 7, 2)
    for f, w in zip(feats, want):
        torch.testing.assert_close(f.grad, w, atol=1e-4, rtol=0.0)


# the mean-teacher step at a 256 canvas, batch 2, the flagship's MT config
MT_SMALL = ["TPU.IMAGE_SIZE", 256, "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 500, "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 500,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128]


def _mt_run(dev, opts=(), swap=()):
    """Two MT steps from iteration START_MT + 1, with the named wrappers'
    kernel calls swapped for their plain versions (else the second with
    synchronising calls made errors); returns (the first step's losses, the
    second's, the kernel launches in the second). The relation head's
    geometric gate is kept off its pole (chip_smoke.WG_BIAS)."""
    import contextlib
    from unittest import mock

    from chip_smoke import MT_LAUNCHES, WG_BIAS, kernel_wrappers
    from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                  unlabeled_to_torch)
    from mmt_psm_tpu_torch.train import build_mt_trainer

    tr = build_mt_trainer(device=dev, seed=0, opts=MT_SMALL + list(opts))
    with torch.no_grad():
        for m in (tr.model, tr.teacher):
            m.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
    tr.iteration = tr.mt.start_mt + 1
    lab = batch_to_torch(generate_batch(1, 2, image_size=256, max_instances=16), dev)
    unl = unlabeled_to_torch(generate_unlabeled_batch(2, 2, image_size=256, max_instances=16), dev)
    wrappers = kernel_wrappers()
    counters = {k: getattr(mod, attr) for k, (mod, attr, _) in wrappers.items()}  # the kernels' wrappers count
    with contextlib.ExitStack() as stack:
        for name in swap:
            stack.enter_context(mock.patch.object(*wrappers[name]))
        first = tr.step(lab, unl)
        torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in counters.items()}
        if not swap:  # the plain versions copy small tables to the card, which syncs
            stack.callback(torch.cuda.set_sync_debug_mode, "default")
            torch.cuda.set_sync_debug_mode("error")
        second = tr.step(lab, unl)
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    assert set(MT_LAUNCHES) == set(launches)
    as_float = lambda d: {k: float(v) for k, v in d.items()}  # noqa: E731
    return as_float(first), as_float(second), launches


def test_mt_step_launches_each_kernel_and_never_syncs(dev):
    """The MT step runs K1 4 times, K2 6 times and K3 3 times, with
    synchronising calls made errors, and its losses are finite."""
    from chip_smoke import MT_LAUNCHES

    _, losses, launches = _mt_run(dev)
    assert launches == MT_LAUNCHES
    assert {"mt_classifier", "mt_fg_loss", "loss_total", "mt_weight"} <= set(losses)
    assert all(map(math.isfinite, losses.values())), losses


def test_mt_step_kernels_match_plain(dev):
    """In float32 (TF32 off) the first MT step's losses with the kernels
    equal those with every kernel's plain version within chip_smoke's
    LOSS_RTOL (a second step starts from weights the two runs moved apart by
    float32 rounding, which the relation head's loss amplifies)."""
    from chip_smoke import LOSS_RTOL

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = ["TPU.COMPUTE_DTYPE", "float32"]
        got, _, _ = _mt_run(dev, f32)
        want, _, launches = _mt_run(dev, f32, swap=("nms", "roi_align", "roi_align_backward"))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert launches == {"nms": 0, "roi_align": 0, "roi_align_backward": 0}
    assert {"mt_classifier", "mt_fg_loss"} <= set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_RTOL * abs(w), (k, got[k], w)


# the serving path at a 256 canvas in float32: 4 windows of a synthetic slide, batches of 3
EVAL_SMALL = ["TPU.IMAGE_SIZE", 256, "TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.PRE_NMS_TOP_N_TEST", 256,
              "MODEL.RPN.POST_NMS_TOP_N_TEST", 256, "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 64]
EVAL_LOADER = dict(max_gt=32, min_size=256, max_size=256, raw_u8=True)
# pasted masks threshold probabilities that the kernels move by float32
# summation order (chip_smoke's flagship f32 check: masks within 1e-3); a
# pixel that flips moves an IoU-based stat of instances of hundreds of
# pixels by well under this
EVAL_STATS_ATOL = 1e-2


def test_run_inference_on_the_card_matches_cpu(dev):
    """``run_inference`` with the model on the card (pinned double-buffered
    staging, normalization on the card, K1 and K2 twice a batch, two eval
    workers) against the same weights on the CPU with the plain versions,
    float32 with TF32 off: the same image count, and every stat within
    EVAL_STATS_ATOL."""
    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
    from mmt_psm_tpu_torch.engine.inference import run_inference
    from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = load_config(opts=EVAL_SMALL)
        cpu, gpu = model_from_cfg(cfg, "cpu"), model_from_cfg(cfg, dev)
        ds = synthetic_slide_dataset(seed=42, num_slides=1, slide_size=512, win_size=256, overlap=0.0,
                                     is_train=False)
        items = own_instances_as_gt(cpu, ds, 3, 256, EVAL_LOADER["max_gt"])
        assert len(items) == 4 and sum(len(it["labels"]) for it in items) > 10
        before = (N.suppress_cuda.launches, P.multilevel_roi_align_cuda.launches)
        got, timing = run_inference(gpu, make_test_loader(items, 3, 256, **EVAL_LOADER), eval_workers=2)
        launched = (N.suppress_cuda.launches - before[0], P.multilevel_roi_align_cuda.launches - before[1])
        want, want_timing = run_inference(cpu, make_test_loader(items, 3, 256, **EVAL_LOADER), eval_workers=0)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert launched == (4, 4)  # two batches, K1 and K2 twice each
    assert timing["images"] == want_timing["images"] == 4
    assert set(got) == set(want)
    for metric, per in want.items():
        assert set(got[metric]) == set(per), metric
        for k, w in per.items():
            assert abs(got[metric][k] - w) <= EVAL_STATS_ATOL, (metric, k, got[metric][k], w)
    assert want["AJI"][1] > 0 and want["mAP"]["all"] > 0


def test_device_stage_launches_without_a_sync(dev):
    """Launching a batch (the copy through pinned staging, normalization on
    the card, the forward, the copies back into pinned buffers) makes no
    synchronising call, in both staging slots and on reuse, so the host
    scores batch i while the card runs batch i + 1; the outputs equal those
    of a forward on the same canvases normalized on the host."""
    import numpy as np

    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
    from mmt_psm_tpu_torch.data.transforms import normalize_bgr255
    from mmt_psm_tpu_torch.engine.inference import DeviceStage
    from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg

    model = model_from_cfg(load_config(opts=EVAL_SMALL), dev)
    ds = synthetic_slide_dataset(seed=1, num_slides=1, slide_size=512, win_size=256, overlap=0.0, is_train=False)
    batches = list(make_test_loader(ds, 2, 256, **dict(EVAL_LOADER, raw_u8=True)))
    stage = DeviceStage(model)
    warm = [stage.dispatch(b) for b in batches]
    [stage.fetch(p) for p in warm]
    torch.cuda.synchronize()

    def launch(*bs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return [stage.dispatch(b) for b in bs]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    p0, p1 = launch(*batches)
    outs = [stage.fetch(p0)]
    (p2,) = launch(batches[0])  # slot 0 again, once its outputs were fetched
    outs += [stage.fetch(p1), stage.fetch(p2)]
    b = batches[0]
    x = np.zeros(b["image"].shape, np.float32)
    for i, (h, w) in enumerate(b["image_size"]):
        x[i, :h, :w] = normalize_bgr255(b["image"][i, :h, :w])
    d = model(torch.from_numpy(x).to(dev), torch.from_numpy(b["image_size"]).to(dev))
    for got in (outs[0], outs[2]):
        np.testing.assert_array_equal(got[3], d.valid.cpu().numpy())
        np.testing.assert_array_equal(got[0], d.boxes.cpu().numpy())
        np.testing.assert_array_equal(got[4], d.masks.half().cpu().numpy())


def test_train_cli_on_the_card(dev, tmp_path):
    """The train CLI on the card at a 256 canvas (``--synthetic --skip-test``,
    batch 2, START_MT 1): its loop launches K1, K2 and K3 as 2 supervised and
    1 MT step make them, saves model_0000002 (and its teacher) and the final
    checkpoints, logs finite losses; a second call resumes at iteration 3."""
    from chip_smoke import MT_LAUNCHES
    from mmt_psm_tpu_torch.tools.train_mean_teacher import main

    counters = {"nms": N.suppress_cuda, "roi_align": P.multilevel_roi_align_cuda,
                "roi_align_backward": P.multilevel_roi_align_backward_cuda}
    sup = {"nms": 1, "roi_align": 2, "roi_align_backward": 2}
    out = str(tmp_path / "run")
    argv = ["--synthetic", "--skip-test", "--output-dir", out, "TPU.IMAGE_SIZE", "256", "SOLVER.IMS_PER_BATCH", "2",
            "MT.START_MT", "1", "SOLVER.CHECKPOINT_PERIOD", "2"]
    before = {k: fn.launches for k, fn in counters.items()}
    res = main(argv + ["SOLVER.MAX_ITER", "3"])
    launched = {k: fn.launches - before[k] for k, fn in counters.items()}
    assert launched == {k: 2 * sup[k] + MT_LAUNCHES[k] for k in sup}
    assert sorted(os.listdir(out)) == ["config.yaml", "last_checkpoint", "log.txt", "model_0000002.pth",
                                       "model_final.pth", "t_model_0000002.pth", "t_model_final.pth"]
    meters = res["trainer"].meters.meters
    assert len(meters["loss_total"].deque) == 3 and len(meters["mt_weight"].deque) == 1
    assert all(math.isfinite(x) for m in meters.values() for x in m.deque)
    res = main(argv + ["SOLVER.MAX_ITER", "4"])
    assert res["start_iter"] == 3 and res["trainer"].steps.iteration == 4


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("what,shape,scale,p,n", [
    # R-50-C4: the box and mask heads pool one stride-16 level of 1024 channels at P14
    ("c4", (2, 64, 64, 1024), 1.0 / 16, 14, 200),
    # PRCNN: a 32-channel full-resolution scale of the image at P25
    ("prcnn", (2, 256, 256, 32), 1.0, 25, 64),
])
def test_roi_align_kernels_one_level(dev, dtype, rtol, what, shape, scale, p, n):
    """K2 and K3 with one level and one scale (every RoI on level 0), as
    the C4 heads and PRCNN's pools call them: K2 within 1e-5 (f32) or one
    bf16 rounding, K3 within 1e-4 (f32) or one bf16 step of the largest
    gradient; one launch each."""
    gen = torch.Generator(device=dev).manual_seed(p)
    canvas = shape[1] / scale
    feat = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    boxes = _boxes(gen, (shape[0], n), canvas, dev)
    before = (P.multilevel_roi_align_cuda.launches, P.multilevel_roi_align_backward_cuda.launches)
    got = P.multilevel_roi_align_cuda([feat], boxes, (scale,), p, 2)
    want = P.multilevel_roi_align_plain([feat], boxes, (scale,), p, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)
    grad = torch.randn(got.shape, generator=gen, device=dev).to(dtype)
    (g,) = P.multilevel_roi_align_backward_cuda(grad, boxes, [shape], (scale,), p, 2)
    (w,) = P.multilevel_roi_align_backward_plain(grad, boxes, [shape], (scale,), p, 2)
    atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(w.float().abs().max())
    torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0.0)
    assert (P.multilevel_roi_align_cuda.launches, P.multilevel_roi_align_backward_cuda.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("name", ["mask_rcnn_fpn", "set_nms", "mask_rel_same_predictor", "rpn_only",
                                  "mask_rcnn_c4", "prcnn", "remat"])
def test_variant_launches_and_never_syncs(dev, name):
    """Each variant at a 256 canvas, batch 2, bf16: a forward under
    synchronising calls made errors and one supervised step launch K1, K2
    and K3 as ``chip_smoke.VARIANT_LAUNCHES`` says; finite losses."""
    from chip_smoke import VARIANT_LAUNCHES, kernel_wrappers
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.models.detector import model_from_cfg
    from mmt_psm_tpu_torch.models.variants import VARIANTS, variant_config
    from mmt_psm_tpu_torch.train import build_trainer

    small = ["TPU.IMAGE_SIZE", "256", "TPU.MAX_GT", "16"]
    path, opts = VARIANTS[name]
    counters = {k: getattr(mod, attr) for k, (mod, attr, _) in kernel_wrappers().items()}
    model = model_from_cfg(variant_config(name, small), dev)
    x = torch.randn(2, 256, 256, 3, device=dev) * 40.0
    sizes = torch.tensor([[256, 256], [200, 240]], dtype=torch.int32, device=dev)
    model(x, sizes)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        model(x, sizes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: fn.launches for k, fn in counters.items()} == VARIANT_LAUNCHES[name][0]
    trainer = build_trainer(path, device=dev, opts=[*opts, *small])
    batch = batch_to_torch(generate_batch(0, 2, image_size=256, max_instances=16), dev)
    for fn in counters.values():
        fn.launches = 0
    losses = trainer.step(batch)
    assert {k: fn.launches for k, fn in counters.items()} == VARIANT_LAUNCHES[name][1]
    assert all(torch.isfinite(v) for v in losses.values())


@pytest.fixture
def small_served(dev):
    """The flagship at a 256 canvas on the card, seed-0 weights, with 4
    synthetic windows whose gt are its own instances (``chip_smoke``'s
    ``datasets bf16`` phase at a small size)."""
    from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
    from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg

    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG

    model = model_from_cfg(load_config(FLAGSHIP_CONFIG, ["TPU.IMAGE_SIZE", "256"]), dev)
    ds = synthetic_slide_dataset(seed=7, num_slides=4, slide_size=256, win_size=256, overlap=0.0, is_train=False,
                                 radius_range=(0.04, 0.09))
    return model, own_instances_as_gt(model, ds, 2, 256, 16)


def test_datasets_phase_helpers_on_the_card(dev, small_served, tmp_path):
    """``write_coco_split`` and ``write_voc_split`` read back through the
    port's COCO and VOC datasets as written; ``predictions_of`` launches K1
    and K2 twice a batch, and the dataset-level evaluators score its
    predictions against the model's own instances: finite, above 0."""
    import numpy as np

    from chip_smoke import VOC_NAMES, predictions_of, write_coco_split, write_voc_split
    from mmt_psm_tpu_torch.data.coco import COCODataset
    from mmt_psm_tpu_torch.data.voc import PascalVOCDataset
    from mmt_psm_tpu_torch.evaluation import evaluate

    model, items = small_served
    write_coco_split(items, str(tmp_path / "coco"))
    write_voc_split(items, str(tmp_path / "voc"))
    coco = COCODataset(str(tmp_path / "coco" / "annotations.json"), str(tmp_path / "coco" / "images"))
    voc = PascalVOCDataset(str(tmp_path / "voc"), "test")
    assert len(coco) == len(voc) == len(items) and coco.json_category_id_to_contiguous_id == {7: 1, 9: 2}
    for i, it in enumerate(items):
        s = coco[i]
        np.testing.assert_array_equal(s["image"], it["image"])
        np.testing.assert_array_equal(s["masks"], it["masks"])
        np.testing.assert_array_equal(s["boxes"], it["boxes"])
        np.testing.assert_array_equal(s["labels"], it["labels"])
        g = voc.get_groundtruth(i)
        np.testing.assert_array_equal(g["boxes"], it["boxes"])
        assert [voc.CLASSES[c] for c in g["labels"]] == [VOC_NAMES[c] for c in it["labels"].tolist()]
    before = (N.suppress_cuda.launches, P.multilevel_roi_align_cuda.launches)
    preds = predictions_of(model, coco, 2, 256)
    n_batches = -(-len(coco) // 2)
    assert (N.suppress_cuda.launches, P.multilevel_roi_align_cuda.launches) == \
        (before[0] + 2 * n_batches, before[1] + 2 * n_batches)
    for iou_type in ("segm", "bbox"):
        r = evaluate(coco, preds, iou_type=iou_type)
        assert 0 < r["AP"] <= 1 and math.isfinite(r["AP50"])
    assert 0 < evaluate(voc, preds)["map"] <= 1


def test_overlays_and_tta_on_the_card(dev, small_served, tmp_path):
    """``run_inference`` with overlays and .mat export on the card writes two
    overlays of the windows' size and a label map an image; a TTA batch's
    views go through the model with K1 and K2 twice a view."""
    import numpy as np
    import scipy.io as sio
    from PIL import Image

    from mmt_psm_tpu_torch.data.loader import make_test_loader, make_tta_loader
    from mmt_psm_tpu_torch.engine import inference as I

    model, items = small_served
    kw = dict(max_gt=16, min_size=256, max_size=256, raw_u8=True)
    _, timing = I.run_inference(model, make_test_loader(items, 2, 256, **kw), eval_workers=0, visual_num=2,
                                visual_dir=str(tmp_path / "vis"), mat_dir=str(tmp_path / "mat"))
    assert timing["images"] == len(items)
    assert sorted(os.listdir(tmp_path / "vis")) == ["vis_0000.png", "vis_0001.png"]
    assert len(os.listdir(tmp_path / "mat")) == len(items)
    assert np.asarray(Image.open(tmp_path / "vis" / "vis_0000.png")).shape == (256, 256, 3)
    assert sio.loadmat(str(tmp_path / "mat" / "img_0000.mat"))["predmap"].max() > 0
    batch = next(make_tta_loader(items, 2, 256, tta_k=2, max_gt=16, min_size=256, max_size=256))
    sizes = torch.from_numpy(batch["image_size"]).to(dev)
    before = (N.suppress_cuda.launches, P.multilevel_roi_align_cuda.launches)
    dets = [model(torch.from_numpy(batch["tta_views"][:, k]).to(dev), sizes) for k in range(2)]
    assert (N.suppress_cuda.launches, P.multilevel_roi_align_cuda.launches) == (before[0] + 4, before[1] + 4)
    assert all(torch.isfinite(d.masks).all() and bool(d.valid.any()) for d in dets)
