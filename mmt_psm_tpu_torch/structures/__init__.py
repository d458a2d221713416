from .boxes import box_area, box_iou, clip_to_image, hflip_boxes, nonempty_mask
from .detections import Detections, GroundTruth, Proposals

__all__ = ["box_area", "box_iou", "clip_to_image", "hflip_boxes", "nonempty_mask", "Detections", "GroundTruth", "Proposals"]
