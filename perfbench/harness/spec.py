"""The files of a cell, found by name under ``perfbench/``."""

from __future__ import annotations

import glob
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _read(*parts) -> dict:
    path = os.path.join(HERE, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no benchmark file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    w = _read("workloads", f"{name}.json")
    if w["name"] != name:
        raise ValueError(f"workloads/{name}.json names itself {w['name']!r}")
    return w


def config(name: str) -> dict:
    return _read("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _read("traffic", f"{name}.json")


def per_layer(cell: str) -> dict:
    """name -> spec of every per-layer metric whose file names an end-to-end
    metric (``moves``) that this cell reports: a new cell takes the metrics
    of what it reports without an edit here, and a reader that finds nothing
    to read in it leaves its metric out of the line."""
    moves = set(end_to_end(cell))
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "metrics", "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        if spec["moves"] in moves:
            out[os.path.basename(path)[:-5]] = spec
    return out


def end_to_end(cell: str) -> dict:
    """name -> entry of ``BENCHMARK.json``'s end-to-end metrics that this cell reports."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {m["name"]: m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
