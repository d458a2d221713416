"""K3, multi-level ROIAlign backward (``counts/kernels.py::k3_roi_align_bwd``)."""

from __future__ import annotations

from ..kernels import k3_roi_align_bwd as work  # noqa: F401

WRAPPER = ("mmt_psm_tpu_torch.ops.pooler", "multilevel_roi_align_backward_cuda")


def keep(args, out):
    """The maps' shapes, the boxes, P and the cotangent's element size."""
    grad, boxes, shapes, scales, p, g = args
    return tuple(tuple(s) for s in shapes), boxes, p, grad.element_size()
