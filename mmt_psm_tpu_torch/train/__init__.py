from .supervised import Trainer, build_trainer

__all__ = ["Trainer", "build_trainer"]
