"""The model FLOPs of the main window's completed units (``perfbench/
counts/flops.py``) over its wall time, as a share in % of the card's
published bf16 dense peak (``perfbench/counts/peaks.json``)."""

from ...counts.kernels import PEAKS


def read(spec, reading):
    return 100.0 * reading.flops_per_unit * reading.window_units / reading.window_s / PEAKS["bf16_flops_per_s"]
