from .mean_teacher import MTTrainer, build_mt_trainer
from .supervised import Trainer, build_trainer

__all__ = ["MTTrainer", "Trainer", "build_mt_trainer", "build_trainer"]
