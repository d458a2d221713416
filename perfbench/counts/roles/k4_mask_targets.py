"""K4, the mask targets (``counts/kernels.py::k4_mask_targets``)."""

from __future__ import annotations

from ..kernels import k4_mask_targets as work  # noqa: F401

WRAPPER = ("mmt_psm_tpu_torch.models.mask_head", "crop_masks_to_boxes_cuda")


def keep(args, out):
    """The masks' shape, the gt rows, the boxes and R: no mask."""
    gt_masks, gt_idx, boxes, resolution = args
    return tuple(gt_masks.shape), gt_idx, boxes, resolution
