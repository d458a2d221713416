"""The R-50-C4 model (the variant ``mask_rcnn_c4``) on the serving path, on the CPU.

* The stage-5 RoI head (``models/c4.py::ResNet50Conv5ROIExtractor``)
  computes in the compute dtype it is given: at bf16 every convolution of
  the head receives bf16, the pooled NHWC features reach the first one
  without a copy, and the output is within bf16 rounding of the float32
  head on the same weights; at float32 it is bit-identical to the head's
  earlier formula (the pooled features cast to float32, then permuted to
  channels_last).
* The benchmark's C4 configuration (``perfbench/configs/mask_rcnn_r50_c4.json``,
  bf16, its ``init`` rules) goes through ``DeviceStage`` at a 128 canvas and
  batch 2, with the RoI counts cut so that the CPU takes seconds: 14 x 14
  float16 masks and detections come back.
* A profiled forward opens the span ``roi_stage5`` twice: once inside
  ``box_head`` and once inside ``mask_head``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmt_psm_tpu_torch.models.c4 import ResNet50Conv5ROIExtractor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS, BATCH = 128, 2
# bf16's unit roundoff: 8 bits of significand
BF16_U = 2.0**-9
# the stage-5 head rounds to bf16 in series about 16 times on any path to
# its output (3 bottlenecks of 3 convolutions, 3 FrozenBN multiply-adds and
# a residual add); independent roundings add in quadrature, so the output's
# relative error norm is about sqrt(16) u = 4u, and its worst element twice that
NORM_RTOL, MAX_RTOL = 4 * BF16_U, 8 * BF16_U
# the cut that keeps a forward of the C4 head to seconds on the CPU:
# 32 proposals and 8 detections an image
SMALL_COUNTS = ["MODEL.RPN.POST_NMS_TOP_N_TEST", "32", "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "32",
                "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", "8"]


@pytest.fixture(scope="module")
def head():
    ex = ResNet50Conv5ROIExtractor(1024).eval()
    ex.init_weights(torch.Generator().manual_seed(1))
    return ex


def _pooled(seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.relu(torch.randn(4, 14, 14, 1024, generator=g)).to(dtype)


def _conv_inputs(ex):
    seen, hooks = [], []
    for m in ex.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_pre_hook(lambda mod, args: seen.append(args[0])))
    return seen, hooks


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_head_computes_in_bf16_within_its_rounding(head, seed):
    pooled = _pooled(seed, torch.bfloat16)
    seen, hooks = _conv_inputs(head)
    try:
        with torch.no_grad():
            lo = head(pooled, torch.bfloat16)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == 10 and all(x.dtype == torch.bfloat16 for x in seen)
    # the first convolutions (conv1 and the downsample) read the pooled features where they lie
    assert seen[0].data_ptr() == pooled.data_ptr()
    assert lo.dtype == torch.bfloat16 and lo.shape == (4, 2048, 7, 7)
    assert lo.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        hi = head(pooled, torch.float32)
    err = (lo.float() - hi).abs()
    assert float(err.norm() / hi.norm()) <= NORM_RTOL
    assert float(err.max()) <= MAX_RTOL * float(hi.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16_pooled", "f32_pooled"])
def test_f32_head_is_the_earlier_formula_bit_for_bit(head, dtype):
    pooled = _pooled(2, dtype)
    with torch.no_grad():
        got = head(pooled, torch.float32)
        want = head.head(pooled.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _c4_conf():
    with open(os.path.join(ROOT, "perfbench", "configs", "mask_rcnn_r50_c4.json")) as f:
        conf = json.load(f)
    opts = [*conf["program"]["opts"], "TPU.IMAGE_SIZE", str(CANVAS), *SMALL_COUNTS]
    return dict(conf, model=dict(conf["model"], image_size=CANVAS), program=dict(conf["program"], opts=opts))


@pytest.fixture(scope="module")
def served():
    """The configuration's model (bf16, its init rules) and one batch of
    raw canvases through ``DeviceStage``: (model, batch, fetched outputs)."""
    from mmt_psm_tpu_torch.engine.inference import DeviceStage

    from perfbench.harness.weights import TRAFFIC_STREAM, fill, generator
    from perfbench.paths.program import program_model
    from perfbench.traffic import cells

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        conf = _c4_conf()
        net = fill(program_model(conf, "cpu"), 2**31 + 18, conf["init"])
        mix = json.load(open(os.path.join(ROOT, "perfbench", "traffic", "serve_windows.json")))
        mix = dict(mix, window=[CANVAS - 8, CANVAS], canvas=CANVAS)
        images = cells.windows(BATCH, mix, generator(2**31 + 18, TRAFFIC_STREAM, "cpu"), "cpu").numpy()
        batch = {"image": images, "image_size": np.array([mix["window"]] * BATCH, np.int32)}
        stage = DeviceStage(net)
        return net, batch, stage.fetch(stage.dispatch(batch))
    finally:
        torch.set_num_threads(n)


def test_c4_serves_14x14_float16_masks_through_the_device_stage(served):
    net, _, (boxes, scores, labels, valid, masks, head_ids) = served
    c = net.config
    assert c.conv_body == "R-50-C4" and c.compute_dtype == "bfloat16" and net.compute_dtype == torch.bfloat16
    assert valid.shape == (BATCH, 8) and valid.sum(1).min() >= 1
    assert masks.dtype == np.float16 and masks.shape == (BATCH, 8, 14, 14)
    assert np.isfinite(masks.astype(np.float32)).all() and np.isfinite(boxes).all() and np.isfinite(scores).all()
    assert head_ids is None


def test_roi_stage5_opens_once_in_each_head(served):
    from mmt_psm_tpu_torch.engine.inference import DeviceStage

    net, batch, _ = served
    stage = DeviceStage(net)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stage.fetch(stage.dispatch(batch))
    parents = []
    for e in prof.events():
        if e.name == "roi_stage5":
            p, names = e.cpu_parent, []
            while p is not None:
                names.append(p.name)
                p = p.cpu_parent
            parents.append({"box_head", "mask_head"}.intersection(names))
    assert sorted(map(sorted, parents)) == [["box_head"], ["mask_head"]]
