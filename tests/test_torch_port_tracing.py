"""The port's ``record_function`` spans, which the benchmark's host and stage
metrics read (``perfbench/metrics/``).

On the CPU, under ``torch.profiler``: one unit of each benchmark cell's path
at a 128 canvas in float32 (a ``DeviceStage`` dispatch and fetch of the
serving cells' models, a ``Trainer.step`` of the supervised cell, an
``MTTrainer.step`` past START_MT of the mean-teacher cell), with the kernel
wrappers called beside their plain versions (their launch a no-op), so the
trace holds every span the card's path emits. Each new span is emitted and
nested where the program puts it; every label a metric file names is
emitted by the path of a cell the metric is read in, and each such metric
finds one of its labels in every one of its cells, so a rename that would
empty a metric fails here; no span is emitted more than ``MAX_PER_UNIT``
times a unit (no span inside a loop). The training loop's spans are read
from the trace that TPU.PROFILE_DIR writes.

Marked ``gpu`` (skips without a card): the kernels K1, K2 and K3, launched
through ctypes, fall under ``k1_nms``, ``k2_roi_align`` and
``k3_roi_align_bwd`` in a card trace, and their launch calls are ones the
``launches`` metric counts. On a GPU host:
``python -m pytest tests/test_torch_port_tracing.py -m gpu --noconftest``.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mmt_psm_tpu_torch.engine import inference
from mmt_psm_tpu_torch.ops import kernels
from mmt_psm_tpu_torch.ops import nms as N
from mmt_psm_tpu_torch.ops import pooler as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = 128
SEED = 2**31 + 15
# the most times one span may open in one batch or step: the MT step's six
# K2 calls are the most any span has
MAX_PER_UNIT = 8
# the counts of proposals, RoIs and detections cut, so the plain NMS and
# ROIAlign take seconds on the CPU
SMALL_COUNTS = ["MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 200, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 100,
                "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 100, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 200,
                "MODEL.RPN.POST_NMS_TOP_N_TEST", 64, "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 64,
                "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 16,
                "MODEL.RELATION_NMS.FIRST_N", 16, "MODEL.RELATION_NMS.TOPK", 16]
BACKWARD_NODE = "autograd::engine::evaluate_function: "

# span -> a span that must be open around it (the test's own ``test.*``
# spans stand for the harness's calls into the program)
NESTED = {
    "device_stage_slot_wait": "test.dispatch", "device_stage_staging": "test.dispatch",
    "device_stage_upload": "test.dispatch", "device_stage_normalize": "test.dispatch",
    "device_stage_copy_out": "test.dispatch",
    "device_stage_fetch_wait": "test.fetch", "device_stage_fetch_copy": "test.fetch",
    "train_step": "test.step",
    "loss_sum": "train_step", "grad_reset": "train_step", "backward": "train_step", "optimizer_step": "train_step",
    "mt_supervised": "train_step", "mt_teacher": "train_step", "mt_student": "train_step",
    "grad_fill": "optimizer_step", "grad_all_reduce": "optimizer_step", "grad_clip": "optimizer_step",
    "sgd_step": "optimizer_step", "ema_update": "optimizer_step",
    "mt_teacher_backbone": "mt_teacher", "mt_teacher_pseudo_labels": "mt_teacher",
    "mt_paste_integral": "mt_teacher", "mt_teacher_box_head": "mt_teacher",
    "mt_student_backbone": "mt_student", "mt_psm": "mt_student", "mt_mgd": "mt_student",
    "mask_head_targets": "mask_head",
}
# a kernel role's span -> the stages that call its wrapper
CALLERS = {
    "k1_nms": {"rpn_select_proposals", "relation_nms", "box_postprocess", "mt_teacher_box_head"},
    "k2_roi_align": {"box_head", "mask_head", "mt_teacher_box_head", "mt_psm"},
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _metric_files():
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "perfbench", "metrics", "*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[:-5]] = json.load(f)
    return out


def _small(name: str):
    """(workload, config, mix) of cell ``name`` at the CPU's size: a 128
    canvas, float32, one image, ``SMALL_COUNTS``."""
    from perfbench.harness import spec

    w = dict(spec.workload(name), batch=1)
    conf = spec.config(w["config"])
    opts = [*conf["program"]["opts"], "TPU.IMAGE_SIZE", CANVAS, "TPU.COMPUTE_DTYPE", "float32", *SMALL_COUNTS]
    opts = [str(x) for x in opts]
    conf = dict(conf, model=dict(conf["model"], image_size=CANVAS), program=dict(conf["program"], opts=opts))
    mix = dict(spec.traffic(w["traffic"]), window=[CANVAS - 8, CANVAS], canvas=CANVAS, pool_batches=1)
    return w, conf, mix


class _NoKernel:
    """A kernel library whose every entry point launches nothing and returns success."""

    def __getattr__(self, name):
        return lambda *args: 0


class _Event:
    def record(self):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass


def _card_path_on_the_cpu(mp):
    """Each kernel wrapper called beside its plain version, which gives the
    result; ``DeviceStage``'s pinned buffers and CUDA events made plain."""
    mp.setattr(kernels, "library", lambda name: _NoKernel())
    mp.setattr(kernels, "stream_handle", lambda device: None)
    mp.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    mp.setattr(torch.cuda, "Event", _Event)
    mp.setattr(inference, "_pinned_empty", lambda shape, dtype: torch.empty(shape, dtype=dtype))
    for module, plain, wrapper in ((N, "suppress_plain", "suppress_cuda"),
                                   (P, "multilevel_roi_align_plain", "multilevel_roi_align_cuda"),
                                   (P, "multilevel_roi_align_backward_plain", "multilevel_roi_align_backward_cuda")):
        def both(*args, _plain=getattr(module, plain), _wrapper=getattr(module, wrapper)):
            _wrapper(*args)
            return _plain(*args)

        mp.setattr(module, plain, both)


def _serve_unit(name):
    from perfbench.harness.weights import TRAFFIC_STREAM, fill, generator
    from perfbench.paths.program import program_model
    from perfbench.traffic import cells

    w, conf, mix = _small(name)
    dev = torch.device("cpu")
    net = fill(program_model(conf, dev), SEED, conf["init"])
    stage = inference.DeviceStage(net)
    stage.cuda = True  # the card's staging path, on plain buffers
    image = cells.windows(w["batch"], mix, generator(SEED, TRAFFIC_STREAM, dev), dev).numpy()
    batch = {"image": image, "image_size": np.array([mix["window"]] * w["batch"], np.int32)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.dispatch"):
            pending = stage.dispatch(batch)
        with record_function("test.fetch"):
            stage.fetch(pending)
    return prof.events()


def _train_unit(name):
    from perfbench.paths import mt_train, train

    w, conf, mix = _small(name)
    run = (mt_train if w["path"] == "mt_train" else train).Run(w, conf, mix, SEED, torch.device("cpu"), 0.0)
    run.tr = run.trainer()
    run.pool = run.make_pool()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.step"):
            run.call(run.tr, run.feed(0))
    return prof.events()


@pytest.fixture(scope="module")
def traces():
    """cell -> the profiler events of one batch or step of its path."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        with pytest.MonkeyPatch.context() as mp:
            _card_path_on_the_cpu(mp)
            return {c["name"]: (_serve_unit if c["name"].startswith("serve.") else _train_unit)(c["name"])
                    for c in _bench()["workloads"]}
    finally:
        torch.set_num_threads(n)


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _emitted(events) -> set:
    names = {e.name for e in events}
    if any(n.startswith(BACKWARD_NODE) for n in names):
        names.add("autograd.backward")  # perfbench/harness/trace.py's pseudo-label of the backward's work
    return names


def test_each_new_span_is_emitted_and_nested(traces):
    events = [e for evs in traces.values() for e in evs]
    seen = set()
    for e in events:
        if e.name in NESTED:
            assert NESTED[e.name] in _ancestors(e), (e.name, _ancestors(e))
            seen.add(e.name)
        elif e.name in CALLERS:
            assert CALLERS[e.name].intersection(_ancestors(e)), (e.name, _ancestors(e))
            seen.add(e.name)
        elif e.name == "k3_roi_align_bwd":
            assert any(a.startswith(BACKWARD_NODE) for a in _ancestors(e)), _ancestors(e)
            seen.add(e.name)
        elif e.name == "mt_hint_adaptor":
            assert {"mt_teacher", "mt_student"}.intersection(_ancestors(e))
    assert seen == set(NESTED) | set(CALLERS) | {"k3_roi_align_bwd"}
    # the harness's calls hold no span of the program beside these
    stages = set().union(*(spec.get("labels", ()) for spec in _metric_files().values()))
    allowed = {"test.step": {"train_step"}, "test.fetch": {"device_stage_fetch_wait", "device_stage_fetch_copy"},
               "test.dispatch": {n for n in NESTED if n.startswith("device_stage_")} | stages}
    for e in events:
        if e.name in allowed:
            kids = {k.name for k in e.cpu_children if not k.name.startswith("aten::")}
            assert kids and kids <= allowed[e.name], (e.name, kids - allowed[e.name])


def test_every_metric_label_is_emitted_in_its_cells(traces):
    bench = {m["name"]: m for m in _bench()["per_layer"]}
    emitted = {cell: _emitted(evs) for cell, evs in traces.items()}
    checked = 0
    for name, spec in _metric_files().items():
        if "labels" not in spec:
            continue
        cells = bench[name]["workloads"]
        union = set().union(*(emitted[c] for c in cells))
        assert set(spec["labels"]) <= union, (name, set(spec["labels"]) - union)
        for c in cells:
            assert emitted[c].intersection(spec["labels"]), (name, c)
        checked += 1
    assert checked >= 30


def test_no_span_is_emitted_in_a_loop(traces):
    labels = set(NESTED) | set(CALLERS) | {"k3_roi_align_bwd", "mt_hint_adaptor"}
    for spec in _metric_files().values():
        labels.update(spec.get("labels", ()))
    for cell, events in traces.items():
        counts = {}
        for e in events:
            if e.name in labels:
                counts[e.name] = counts.get(e.name, 0) + 1
        assert counts and max(counts.values()) <= MAX_PER_UNIT, (cell, counts)


def _labeled():
    i = 0
    while True:
        yield {"image": np.full((1, 1), i, np.float32)}
        i += 1


def _unlabeled():
    while True:
        yield {"t_images": np.zeros((1, 1), np.float32)}


def test_training_loop_spans_in_the_operators_trace(tmp_path):
    """TPU.PROFILE_DIR's trace names the loop's host work between steps: the
    feed, the losses' read and the save."""
    from mmt_psm_tpu_torch.config import get_cfg
    from mmt_psm_tpu_torch.engine import trainer
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG
    from mmt_psm_tpu_torch.train.mean_teacher import MTTrainer

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP_CONFIG)
    cfg.merge_from_list(["MT.START_MT", "1", "SOLVER.IMS_PER_BATCH", "1", "SOLVER.MAX_ITER", "4",
                         "SOLVER.CHECKPOINT_PERIOD", "2", "TPU.MESH_SHAPE", "[1]", "TPU.PROFILE_DIR",
                         str(tmp_path / "prof"), "TPU.PROFILE_START", "1", "TPU.PROFILE_STEPS", "2"])
    steps = MTTrainer(torch.nn.Linear(2, 2), torch.nn.Linear(2, 2).requires_grad_(False), cfg,
                      torch.Generator().manual_seed(0))
    loop = trainer.MTTrainer(steps, _labeled(), _unlabeled(), output_dir=str(tmp_path / "run"))
    taken = []

    def step(batch, unlabeled=None):
        taken.append(unlabeled is not None)
        steps.iteration += 1
        return {"loss_total": torch.zeros(())}

    loop._sup_step, loop._mt_step = step, step
    loop.train(0)
    assert taken == [False, False, True, True]
    (path,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # iterations 1 and 2 traced, the save after iteration 2
    assert {n: names.count(n) for n in ("loop_feed", "loop_read_losses", "loop_checkpoint")} == {
        "loop_feed": 2, "loop_read_losses": 2, "loop_checkpoint": 1}


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_launched_through_ctypes_fall_under_their_spans(dev):
    from perfbench.harness.trace import BACKWARD_LABEL, device_intervals
    from perfbench.metrics.readers.launches import is_launch

    kernels.build_all()
    gen = torch.Generator(device=dev).manual_seed(5)
    xy = torch.rand(2, 300, 2, generator=gen, device=dev) * 200
    boxes = torch.cat([xy, xy + 8 + 40 * torch.rand(2, 300, 2, generator=gen, device=dev)], -1)
    scores = torch.rand(2, 300, generator=gen, device=dev)
    valid = torch.ones(2, 300, dtype=torch.bool, device=dev)
    feats = [torch.randn(2, 64 >> i, 64 >> i, 32, generator=gen, device=dev).requires_grad_() for i in range(4)]
    for _ in range(2):  # the second pass is the traced one
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            N.nms_mask(boxes, scores, valid, 0.5)
            pooled = P.multilevel_roi_align(feats, boxes[:, :40] * 0.5, (0.25, 0.125, 0.0625, 0.03125), 7, 2)
            pooled.float().sum().backward()
            torch.cuda.synchronize()
    events = prof.events()
    labels = {"k1_nms", "k2_roi_align", "k3_roi_align_bwd", BACKWARD_LABEL}
    dev_ivs, _ = device_intervals(events, labels)
    want = {"nms_iou_mask_kernel": "k1_nms", "nms_block_scan_kernel": "k1_nms", "roi_align_kernel": "k2_roi_align",
            "roi_footprint_kernel": "k3_roi_align_bwd", "roi_align_backward_kernel": "k3_roi_align_bwd"}
    found = {}
    for iv in dev_ivs:
        for kernel, span in want.items():
            if kernel in iv.name:
                found.setdefault(kernel, set()).update(iv.labels)
    assert set(found) == set(want), found
    for kernel, span in want.items():
        assert span in found[kernel], (kernel, found[kernel])
    # each kernel's launch call is one the launches metric counts
    by_id = {e.id: e for e in events if not str(e.device_type).endswith("CUDA") and e.name.startswith("cu")}
    for e in events:
        if str(e.device_type).endswith("CUDA") and any(k in e.name for k in want):
            assert e.id in by_id and is_launch(by_id[e.id].name), (e.name, by_id.get(e.id))
