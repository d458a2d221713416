"""The benchmark's cells cut to a CPU's size (128 canvas, batch 2, two
pool batches) for the tests' rehearsals of a whole run."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SERVE_CELLS = ("serve.mmt_psm_r50_fpn.b16", "serve.mask_rcnn_r50_fpn.b16")
CANVAS = 128


def small_cell(name: str):
    """(workload, config, mix) of cell ``name`` at the CPU's size."""
    from perfbench.harness import spec

    w = dict(spec.workload(name), batch=2, warmup=1, trace_batches=2)
    conf = spec.config(w["config"])
    conf = dict(conf, model=dict(conf["model"], image_size=CANVAS),
                program=dict(conf["program"], opts=[*conf["program"]["opts"], "TPU.IMAGE_SIZE", str(CANVAS)]))
    mix = dict(spec.traffic(w["traffic"]), window=[CANVAS - 8, CANVAS], canvas=CANVAS, pool_batches=2)
    return w, conf, mix

TRAIN_CELLS = ("train.mask_rcnn_r50_fpn.b16",)
MT_CELLS = ("mt_train.mmt_psm_r50_fpn.b16",)


def small_train_cell(name: str):
    """(workload, config, mix) of training cell ``name`` at the CPU's size."""
    from perfbench.harness import spec

    w = dict(spec.workload(name), batch=2, trace_steps=1)
    conf = spec.config(w["config"])
    conf = dict(conf, model=dict(conf["model"], image_size=CANVAS),
                program=dict(conf["program"], opts=[*conf["program"]["opts"], "TPU.IMAGE_SIZE", str(CANVAS)]))
    mix = dict(spec.traffic(w["traffic"]), window=[CANVAS - 8, CANVAS], canvas=CANVAS)
    return w, conf, mix

