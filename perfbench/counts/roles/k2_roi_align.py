"""K2, multi-level ROIAlign forward (``counts/kernels.py::k2_roi_align``)."""

from __future__ import annotations

from ..kernels import k2_roi_align as work  # noqa: F401

WRAPPER = ("mmt_psm_tpu_torch.ops.pooler", "multilevel_roi_align_cuda")


def keep(args, out):
    """The maps' shapes, the boxes, scales, P, the grid and the element size:
    no feature map."""
    features, boxes, scales, p, g = args
    return tuple(tuple(f.shape) for f in features), boxes, tuple(scales), p, g, features[0].element_size()
