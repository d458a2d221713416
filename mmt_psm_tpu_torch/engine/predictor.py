"""Single-image predictor (the port's copy of
``mmt_psm_tpu/engine/predictor.py``, after the reference's COCODemo,
demo/predictor.py:13-358): resize and normalize a raw RGB uint8 image,
run the model on the device of its parameters, map the detections back to
the image's own coordinates and paste their masks; ``run_on_image`` draws
them over the image (``utils/visual.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import transforms as T
from ..utils.visual import overlay_instances
from .paste import detections_to_instseg

CATEGORIES = ["__background", "cytoplasm", "nuclei"]  # Pap.py:107-111


class CellDemo:
    def __init__(self, model, canvas: int | None = None, min_size: int = 800, max_size: int = 1333,
                 confidence_threshold: float = 0.5):
        self.model = model
        self.device = next(model.parameters()).device
        self.canvas = canvas or model.config.image_size
        self.min_size = min_size
        self.max_size = max_size
        self.confidence_threshold = confidence_threshold

    def compute_prediction(self, image_rgb: np.ndarray):
        """image_rgb: u8 [H, W, 3]. Returns a dict of boxes, scores and
        labels (in the image's own coordinates), label names, and the masks
        as per-class InstSeg."""
        h0, w0 = image_rgb.shape[:2]
        img = T.test_transform({"image": image_rgb}, self.min_size, self.max_size)["image"]
        h, w = img.shape[:2]
        assert h <= self.canvas and w <= self.canvas, "canvas too small for resized image"
        padded = np.zeros((1, self.canvas, self.canvas, 3), np.float32)
        padded[0, :h, :w] = img
        size = torch.tensor([[h, w]], dtype=torch.int32, device=self.device)
        d = self.model(torch.from_numpy(padded).to(self.device), size)
        boxes, scores, labels, valid, masks = (x[0].cpu().numpy() for x in (d.boxes, d.scores, d.labels, d.valid,
                                                                             d.masks))
        keep = valid & (scores >= self.confidence_threshold)
        # boxes back to the original image (predictor.py:208-219)
        sx, sy = w0 / w, h0 / h
        out_boxes = boxes[keep] * np.array([sx, sy, sx, sy], np.float32)
        out_scores = scores[keep]
        out_labels = labels[keep]
        inst = detections_to_instseg(out_boxes, out_scores, out_labels, np.ones(keep.sum(), bool), masks[keep],
                                     (h0, w0))
        return {
            "boxes": out_boxes,
            "scores": out_scores,
            "labels": out_labels,
            "label_names": [CATEGORIES[int(lab)] for lab in out_labels],
            "masks": inst,
        }

    def run_on_image(self, image_rgb: np.ndarray) -> np.ndarray:
        """The prediction drawn over the image, u8 [H, W, 3] RGB
        (run_on_opencv_image, predictor.py:161-182)."""
        return overlay_instances(image_rgb, self.compute_prediction(image_rgb))
