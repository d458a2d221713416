from .detector import FLAGSHIP_CONFIG, MaskRCNN, ModelConfig, build_model, resolve_device

__all__ = ["FLAGSHIP_CONFIG", "MaskRCNN", "ModelConfig", "build_model", "resolve_device"]
