"""PyTorch/CUDA port of mmt_psm_tpu: MMT-PSM on NVIDIA Hopper.

``build_model(config_path, device=...)`` builds the flagship Mask R-CNN
R-50-FPN with relation-NMS and CIAM; ``model(images, image_sizes)`` runs
the test-time graph through the hand-written kernels in ``csrc/``.
``train.build_trainer`` builds the same model with its SGD step;
``Trainer.step(batch)`` runs the supervised train step.
"""

from .models import MaskRCNN, ModelConfig, build_model

__all__ = ["MaskRCNN", "ModelConfig", "build_model"]
