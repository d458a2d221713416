"""Model FLOP counts, one file a count: ``<name>.py`` gives
``count(model, batch)``, the FLOPs by stage of one unit of work (a batch
served or a training step) of ``batch`` images. The ``flops`` key of a
configuration (serving) or of a workload (training) names the file, so a
new configuration brings its count as a new file."""

from __future__ import annotations

import importlib


def count(name: str, model: dict, batch: int) -> dict:
    """FLOPs by stage of the count ``name`` on the model sizes ``model``."""
    return importlib.import_module(f"{__name__}.{name}").count(model, batch)
