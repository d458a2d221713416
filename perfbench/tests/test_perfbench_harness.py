"""The harness on the CPU: what it imports, that a run without a card
fails, that every file of every cell is found by name, the arithmetic that
turns times and traces into metrics (rates, the p95 over all batches, the
union of device intervals and the idle share, the work of autograd's
nodes), the judge's matching, and a whole run rehearsed at a small size."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys
import types

import pytest

from perfbench_small import ROOT, SERVE_CELLS, small_cell

HERE = os.path.join(ROOT, "perfbench")
BANNED = {"jax", "jaxlib", "flax", "mmt_psm_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in glob.glob(os.path.join(HERE, sub, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_jax_imported_by_the_benchmark():
    for path in _sources():
        assert not BANNED.intersection(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert not (BANNED | {"mmt_psm_tpu_torch", "perfbench"}).intersection(names), path


def test_loaded_modules_hold_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.harness.main, perfbench.paths.serve, "
            "perfbench.judge.detections, perfbench.control, perfbench.metrics.readers.roofline; "
            "from perfbench.harness import guard; import mmt_psm_tpu_torch.engine.inference; "
            "print(guard.banned_loaded())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names():
    from perfbench.harness.guard import banned_loaded

    assert banned_loaded(["mmt_psm_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert banned_loaded(["mmt_psm_tpu.models", "jax.numpy", "flax"]) == ["flax", "jax", "mmt_psm_tpu"]


def test_run_without_a_card_fails():
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", SERVE_CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_file_is_found_by_name():
    import importlib

    from perfbench.harness import spec

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        conf = spec.config(c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json" and conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
    for cell in bench["workloads"]:
        w = spec.workload(cell["name"])
        assert (w["config"], w["traffic"], w["chips"]) == (cell["config"], cell["traffic"], cell["chips"])
        spec.config(w["config"])
        spec.traffic(w["traffic"])
        importlib.import_module(f"perfbench.paths.{w['path']}")
        assert w["check"]["limits"]
        assert "setup_s" in spec.end_to_end(cell["name"])
        assert spec.per_layer(cell["name"])
    files = {os.path.basename(p)[:-5] for p in glob.glob(os.path.join(HERE, "metrics", "*.json"))}
    assert files == {m["name"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        s = json.load(open(os.path.join(HERE, "metrics", m["name"] + ".json")))
        for k in ("unit", "better", "source", "layer", "moves"):
            assert s[k] == m[k], (m["name"], k)
        importlib.import_module(f"perfbench.metrics.readers.{s['reader']}")
        # the harness reads the metric in every cell that reports what it moves
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert m["name"] in spec.per_layer(cell), (m["name"], cell)


def test_a_new_cell_takes_the_metrics_of_what_it_reports(monkeypatch):
    from perfbench.harness import spec

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    e2e = [dict(m) for m in bench["end_to_end"]]
    for m in e2e:
        if "workloads" in m and "serve.mmt_psm_r50_fpn.b16" in m["workloads"]:
            m["workloads"] = [*m["workloads"], "serve.new_model.b16"]
    monkeypatch.setattr(spec, "end_to_end", lambda cell: {
        m["name"]: m for m in e2e if "workloads" not in m or cell in m["workloads"]})
    new = spec.per_layer("serve.new_model.b16")
    assert new == spec.per_layer("serve.mmt_psm_r50_fpn.b16")
    assert {s["moves"] for s in new.values()} == {"patches_per_s"}


# -- arithmetic on canned data ---------------------------------------------
def _iv(s, e, name="k", labels=()):
    from perfbench.harness.trace import Interval

    return Interval(s, e, name, tuple(labels))


def test_union_and_idle():
    from perfbench.harness import trace as T

    ivs = [_iv(0.0, 1.0), _iv(0.5, 1.5), _iv(2.0, 3.0), _iv(2.2, 2.4), _iv(5.0, 6.0)]
    assert T.union_seconds(ivs) == pytest.approx(3.5)
    assert T.union_seconds(ivs, 0.75, 2.5) == pytest.approx(1.25)
    gaps = T.idle_gaps(ivs, -1.0, 5.5)
    assert gaps == [(3.0, 5.0), (-1.0, 0.0), (1.5, 2.0)]
    host = [_iv(2.9, 4.0, "backbone"), _iv(2.5, 6.0, "perfbench.dispatch")]
    assert T.gaps_by_host(gaps, host, 2) == [["perfbench.dispatch", 2.0], ["no label", 1.0]]
    assert T.top_ops([_iv(0, 1, "a"), _iv(1, 3, "b"), _iv(3, 4, "a")]) == [["a", 2.0], ["b", 2.0]]


def test_stage_union_per_unit_and_rooflines():
    from perfbench.harness.reading import TraceReading

    r = TraceReading(events=[], calls={"k1_nms": []}, units=2, first="d", last="f", window_units=10,
                     window_s=2.0, flops_per_unit=1e12, enqueue_ms=[1.0, 3.0])
    r.dev = [_iv(0.0, 0.010, "conv", ["backbone"]), _iv(0.005, 0.012, "add", ["backbone"]),
             _iv(0.020, 0.021, "nms_iou_mask_kernel<float>", ["rpn_select_proposals"]),
             _iv(0.030, 0.040, "roi_align_kernel", ["box_head"])]
    r.host = []
    r.lo, r.hi = 0.0, 0.050
    assert r.union_ms_per_unit(["backbone"]) == pytest.approx(6.0)
    assert r.union_ms_per_unit(["relation_nms"]) is None
    assert r.kernel_seconds(["nms_iou_mask_kernel", "nms_block_scan_kernel"]) == pytest.approx(0.001)
    assert r.busy_and_window() == (pytest.approx(0.023), pytest.approx(0.05))
    from perfbench.metrics.readers import enqueue_ms, idle_share, mfu, roofline

    assert idle_share.read({}, r) == pytest.approx(54.0)
    assert enqueue_ms.read({}, r) == 2.0
    assert mfu.read({}, r) == pytest.approx(100 * 1e12 * 10 / 2.0 / 989e12)
    assert roofline.read({"count": "k1_nms", "kernels": ["nms_iou_mask_kernel"]}, r) is None


def test_rate_and_p95_over_all_batches():
    import statistics

    from perfbench.paths.serve import Run

    run = Run.__new__(Run)
    run.batch, run.window_s, run.setup_s, run.memory_peak_bytes = 16, 2.0, 9.5, 3 * 2**30
    run.times = [(i * 0.1, i * 0.1 + 0.01, i * 0.1 + 0.05 + (0.1 if i == 7 else 0.0)) for i in range(20)]
    got = run.end_to_end()
    assert got["patches_per_s"] == pytest.approx(20 * 16 / 2.0)
    lat = [50.0] * 19 + [150.0]
    assert got["batch_p95_ms"] == pytest.approx(statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert got["batch_p95_ms"] == pytest.approx(55.0)
    assert got["peak_mem_gib"] == 3.0 and got["setup_s"] == 9.5


def _ev(name, eid=0, start=0.0, end=0.0, parent=None, device=False, thread=1):
    """A profiler event as ``device_intervals`` reads it (times in us)."""
    return types.SimpleNamespace(name=name, id=eid, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type="DeviceType.CUDA" if device else "DeviceType.CPU", cpu_parent=parent,
                                 thread=thread)


def test_device_intervals_follow_the_launch():
    from perfbench.harness.trace import device_intervals

    stage = _ev("box_head", 1, 0, 100)
    op = _ev("aten::linear", 2, 10, 50, stage)
    launch = _ev("cudaLaunchKernel", 77, 20, 30, op)
    ctypes_launch = _ev("cuLaunchKernel", 78, 60, 70, stage)
    events = [stage, op, launch, ctypes_launch, _ev("box_head", 1, 40, 140, device=True),
              _ev("gemm", 77, 40, 90, device=True), _ev("roi_align_kernel", 78, 95, 99, device=True),
              _ev("orphan", 99, 200, 210, device=True)]
    dev, host = device_intervals(events, {"box_head"})
    assert [(i.name, i.labels) for i in dev] == [("gemm", ("box_head",)), ("roi_align_kernel", ("box_head",)),
                                                ("orphan", ())]
    assert dev[0].start == pytest.approx(40e-6) and dev[0].end == pytest.approx(90e-6)
    assert [(h.name, h.start, h.end) for h in host] == [("box_head", 0.0, 100e-6)]


def test_backward_work_is_found_by_its_autograd_nodes():
    from perfbench.harness.trace import BACKWARD_LABEL, BACKWARD_NODE, device_intervals

    step = _ev("optimizer_step", 1, 0, 100)
    node = _ev(BACKWARD_NODE + "ConvolutionBackward0", 2, 0, 50, thread=2)
    op = _ev("aten::convolution_backward", 3, 5, 40, node, thread=2)
    launch = _ev("cudaLaunchKernel", 80, 10, 12, op, thread=2)
    opt_launch = _ev("cudaLaunchKernel", 81, 60, 62, step)
    events = [step, node, op, launch, opt_launch, _ev("wgrad", 80, 20, 45, device=True),
              _ev("sgd", 81, 70, 75, device=True)]
    dev, _ = device_intervals(events, {"optimizer_step", BACKWARD_LABEL})
    assert [(i.name, i.labels) for i in dev] == [("wgrad", (BACKWARD_LABEL,)), ("sgd", ("optimizer_step",))]
    dev, _ = device_intervals(events, {"optimizer_step"})
    assert dev[0].labels == ()


# -- a whole run, rehearsed ------------------------------------------------
@pytest.mark.parametrize("name", SERVE_CELLS)
def test_rehearsed_run_is_correct(name):
    import argparse
    import time

    import torch

    from perfbench.harness import main as M

    w, conf, mix = small_cell(name)
    a = argparse.Namespace(seed=2**31 + 77, seconds=1.0, trace=1)
    r = M.measure(a, torch.device("cpu"), time.perf_counter(), w, conf, mix)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= w["batch"]
    assert list(r)[-1] == "checks"
    assert r["checks"] and all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert r["device"]["window_s"] > 0


def test_judge_matches_degenerate_boxes_and_counts_both_sides():
    import numpy as np

    from perfbench.judge.detections import Tally

    boxes = np.array([[[10, 10, 10, 40], [50, 50, 90, 90], [0, 0, 5, 5]]], np.float32)  # the first has zero width
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    labels = np.array([[1, 2, 1]], np.int32)
    valid = np.array([[True, True, True]])
    masks = np.full((1, 3, 4, 4), 0.5, np.float16)
    t = Tally()
    t.add((boxes, scores, labels, valid, masks), (boxes, scores, labels, valid), masks.astype(np.float32))
    assert t.numbers() == {"unmatched": 0.0, "score_gap": 0.0, "mask_gap": 0.0}
    served_valid = valid.copy()
    served_valid[0, 1] = False  # one detection the reference has is not served
    moved = boxes.copy()
    moved[0, 2] += 30  # one served detection moved away
    t = Tally()
    t.add((moved, scores, labels, served_valid, masks), (boxes, scores, labels, valid),
          np.full((1, 3, 4, 4), 0.25, np.float32))
    n = t.numbers()
    assert n["unmatched"] == 3 / 5 and n["mask_gap"] == 0.25
