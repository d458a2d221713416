"""K1, greedy NMS on score-sorted problems (``counts/kernels.py::k1_nms``)."""

from __future__ import annotations

from ..kernels import k1_nms as work  # noqa: F401

WRAPPER = ("mmt_psm_tpu_torch.ops.nms", "suppress_cuda")


def keep(args, out):
    """The sorted boxes, valid flags and the output's suppression flags."""
    return args[0], args[1], out
