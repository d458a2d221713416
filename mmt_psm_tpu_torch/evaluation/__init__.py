"""Evaluation on the host (numpy plus the C++ library ``csrc/papeval.cpp``):
the port's own copies of the JAX package's ``evaluation/instmask.py``,
``pap_eval.py``, ``coco_eval.py``, ``voc_eval.py`` and ``dispatch.py``.
``evaluate(dataset, predictions)`` picks the evaluator of the dataset's
type. Nothing here imports torch."""

from .dispatch import evaluate
from .instmask import InstSeg, iou_int_uni
from .pap_eval import PapEvaluator

__all__ = ["InstSeg", "iou_int_uni", "PapEvaluator", "evaluate"]
