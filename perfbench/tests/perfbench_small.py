"""The benchmark's cells cut to a CPU's size (128 canvas, batch 2, two
pool batches) for the tests' rehearsals of a whole run. The cells are
``BENCHMARK.json``'s, grouped by their workload file's ``path``."""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cells(path: str) -> tuple:
    from perfbench.harness import spec

    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        names = [w["name"] for w in json.load(f)["workloads"]]
    return tuple(n for n in names if spec.workload(n)["path"] == path)


SERVE_CELLS = _cells("serve")
TRAIN_CELLS = _cells("train")
MT_CELLS = _cells("mt_train")
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


def small_train_cell(name: str):
    """(workload, config, mix) of training cell ``name`` at the CPU's size."""
    from perfbench.harness import spec

    w = dict(spec.workload(name), batch=2, trace_steps=1)
    conf = spec.config(w["config"])
    conf = dict(conf, model=dict(conf["model"], image_size=CANVAS),
                program=dict(conf["program"], opts=[*conf["program"]["opts"], "TPU.IMAGE_SIZE", str(CANVAS)]))
    mix = dict(spec.traffic(w["traffic"]), window=[CANVAS - 8, CANVAS], canvas=CANVAS)
    return w, conf, mix


@contextlib.contextmanager
def roles_on_the_cpu(raw: dict | None = None):
    """The CPU path routed through each kernel role's wrapper attribute
    (``perfbench/counts/roles/``), which then holds the role's plain version
    (``<name>_plain`` beside ``<name>_cuda``), so the recorders see the calls
    that the card's path makes, with the plain results. ``raw`` gets
    role -> [(args, out)] of every call."""
    from perfbench.counts import roles

    raw = {} if raw is None else raw
    undo = []
    try:
        for name in roles.names():
            module_name, wrapper = roles.role(name).WRAPPER
            module = importlib.import_module(module_name)
            plain_name = wrapper[:-len("_cuda")] + "_plain"
            plain, orig = getattr(module, plain_name), getattr(module, wrapper)

            def stand_in(*args, _plain=plain, _seen=raw.setdefault(name, [])):
                out = _plain(*args)
                _seen.append((args, out))
                return out

            stand_in.launches = 0
            undo += [(module, wrapper, orig), (module, plain_name, plain)]
            setattr(module, wrapper, stand_in)
            setattr(module, plain_name, lambda *args, _m=module, _w=wrapper: getattr(_m, _w)(*args))
        yield
    finally:
        for module, attr, value in reversed(undo):
            setattr(module, attr, value)
