"""PyTorch/CUDA port of mmt_psm_tpu: MMT-PSM inference on NVIDIA Hopper.

``build_model(config_path, device=...)`` builds the flagship Mask R-CNN
R-50-FPN with relation-NMS and CIAM; ``model(images, image_sizes)`` runs
the test-time graph through the hand-written kernels in ``csrc/``.
"""

from .models import MaskRCNN, ModelConfig, build_model

__all__ = ["MaskRCNN", "ModelConfig", "build_model"]
