"""Per-layer readers. Each metric's file (``perfbench/metrics/<name>.json``)
names its reader (``perfbench/metrics/readers/<reader>.py``), whose
``read(spec, reading)`` returns the number, or None where the segment holds
nothing to read: that metric is then left out of the line."""

from __future__ import annotations

import importlib


def read_all(specs: dict, reading) -> dict:
    labels = set()
    for s in specs.values():
        labels.update(s.get("labels", ()))
    reading.resolve(labels)
    out = {}
    for name, spec in specs.items():
        value = importlib.import_module(f"{__name__}.{spec['reader']}").read(spec, reading)
        if value is not None:
            out[name] = value
    return out
