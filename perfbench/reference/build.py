"""The plain reference model of a benchmark configuration.

``ModelConfig`` comes from the ``model`` block of the configuration's file
(``perfbench/configs/<config>.json``), never from the program's config
reader, so the reference reads nothing of the program. ``dtype`` is the
precision it computes in: the configuration's own (``model.compute_dtype``)
for the reference, a lower one for the control (``control.py``).
"""

from __future__ import annotations

import copy
import types

import torch

from .models.detector import MaskRCNN, ModelConfig
from .models.mask_relation import MaskRelationConfig
from .models.relation import RelationNMSConfig


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def model_config(model: dict) -> ModelConfig:
    """The ``model`` block of a configuration file as a ``ModelConfig``."""
    d = _tuples(model)
    d["relation"] = RelationNMSConfig(**_tuples(d["relation"])) if d.get("relation") else None
    d["relation_mask"] = MaskRelationConfig(**_tuples(d["relation_mask"])) if d.get("relation_mask") else None
    return ModelConfig(**d)


def reference_model(model: dict, device) -> MaskRCNN:
    """The reference network in eval mode, parameters float32 and
    unfilled: the benchmark fills them from the seed (``harness/weights.py``).
    Its float32 products run in float32, not TF32 (the process's setting:
    the reference runs after the program)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        net = MaskRCNN(model_config(model))
    return net.to(device)


def _namespace(d):
    return types.SimpleNamespace(**{k: _namespace(v) if isinstance(v, dict) else v for k, v in d.items()})


def train_cfg(conf: dict, opts: dict):
    """The SOLVER, MT and MODEL.RELATION_NMS keys of a configuration's
    ``train`` block, with the cell's ``KEY.PATH: value`` overrides, as the
    attribute tree the training step reads."""
    tree = copy.deepcopy(conf["train"])
    for key, value in opts.items():
        node = tree
        *path, last = key.split(".")
        for part in path:
            node = node[part]
        if last not in node:
            raise KeyError(f"{key} is not a key of the configuration's train block")
        node[last] = value
    return _namespace(tree)


def train_model_config(conf: dict, cfg) -> dict:
    """The ``model`` block of the training graph: the MGD hint adaptor where MT.FG_HINT > 0."""
    return dict(conf["model"], with_hint_adaptor=bool(cfg.MT.FG_HINT > 0))
