"""The benchmark's FLOP count of Mask R-CNN R-50-C4 (``perfbench/counts/
models/mask_rcnn_c4.py``) and the reader of the stage-5 head's share of the
compute roofline (``perfbench/metrics/readers/stage_roofline.py``).

The count at batch 16 on the cell's configuration is pinned; at a small
canvas with few RoIs it equals ``FlopCounterMode`` over the reference's
forward; the roofline reader turns canned device intervals into the
stage's share and reads nothing in a cell of another configuration.
"""

import json
import os

import pytest
import torch

from perfbench.counts.models import count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "mask_rcnn_r50_c4"
# batch 16 at the published widths: 1,000 box RoIs and 200 detections an
# image on the 1024 canvas; 32.11 TFLOP, the stage-5 head 87.6% of it
PINNED = {"backbone": 2088964718592, "rpn_head": 1247016910848, "box_stage5": 23429382144000,
          "box_head": 983040000, "mask_stage5": 4685876428800, "mask_head": 658630246400}


def _conf(name=CONFIG):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_count_at_batch_16_equals_the_pinned():
    conf = _conf()
    assert conf["flops"] == "mask_rcnn_c4"
    got = count(conf["flops"], conf["model"], 16)
    assert got == PINNED
    assert sum(got.values()) == 32110853488640
    # every term is linear in the batch, as the roofline reader takes it to be
    assert {k: 16 * v for k, v in count(conf["flops"], conf["model"], 1).items()} == got


def test_count_equals_flop_counter_on_the_reference():
    """64 canvas (4 x 4 cells at stride 16), 12 proposals and 4 detections an image, float32."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.harness.weights import fill
    from perfbench.reference import serve as RS
    from perfbench.reference.build import reference_model

    conf = _conf()
    model = dict(conf["model"], compute_dtype="float32", image_size=64, post_nms_top_n_test=12,
                 fpn_post_nms_top_n_test=12, detections_per_img=4)
    net = fill(reference_model(model, "cpu"), 3, conf["init"]).eval()
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    sizes = torch.tensor([[60, 64], [64, 64]], dtype=torch.int32)
    with FlopCounterMode(display=False) as counter:
        RS.detect(net, images, sizes)
    assert sum(count(conf["flops"], model, 2).values()) == counter.get_total_flops()


def _reading(flops_per_unit, stage_ms, units=2):
    from perfbench.harness.reading import TraceReading
    from perfbench.harness.trace import Interval

    r = TraceReading(events=[], calls={}, units=units, first="d", last="f", window_units=10, window_s=1.0,
                     flops_per_unit=flops_per_unit, enqueue_ms=[])
    # the stage's work: two overlapping intervals under box_head and one under mask_head, and work outside it
    per = stage_ms * units * 1e-3
    r.dev = [Interval(0.0, 0.6 * per, "gemm", ("box_head", "roi_stage5")),
             Interval(0.5 * per, 0.8 * per, "add", ("box_head", "roi_stage5")),
             Interval(1.0, 1.0 + 0.2 * per, "gemm", ("mask_head", "roi_stage5")),
             Interval(2.0, 2.5, "conv", ("backbone",))]
    r.host, r.lo, r.hi = [], 0.0, 3.0
    return r


def test_stage_roofline_reads_the_stage_flops_over_its_device_time():
    from perfbench.counts.kernels import PEAKS
    from perfbench.metrics.readers import stage_roofline

    with open(os.path.join(ROOT, "perfbench", "metrics", "roi_stage5_roofline.serve.json")) as f:
        spec = json.load(f)
    assert spec["config"] == CONFIG and spec["stages"] == ["box_stage5", "mask_stage5"]
    total = sum(PINNED.values())
    stage = PINNED["box_stage5"] + PINNED["mask_stage5"]
    got = stage_roofline.read(spec, _reading(total, 60.0))
    assert got == pytest.approx(100.0 * stage / 60e-3 / PEAKS["bf16_flops_per_s"])
    assert 40.0 < got < 50.0
    # no span in the segment, or the FLOPs of another configuration's cell: nothing read
    assert stage_roofline.read(spec, _reading(total, 0.0)) is None
    fpn = _conf("mask_rcnn_r50_fpn")
    assert stage_roofline.read(spec, _reading(sum(count(fpn["flops"], fpn["model"], 16).values()), 60.0)) is None
