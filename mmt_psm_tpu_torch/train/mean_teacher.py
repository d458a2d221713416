"""The mean-teacher MMT-PSM train step (port of ``make_mt_step``,
``mmt_psm_tpu/train/mt_step.py:468-524``, and the host switch of
``mmt_psm_tpu/engine/trainer.py:94-99``).

``build_mt_trainer`` is the entry point: the student is the model of a
YAML config in train mode with the MGD hint adaptor, the teacher a copy of
it made at build time (the JAX ``create_train_state(..., with_teacher=True)``),
in eval mode and without gradients; on the card unless the caller asks for
the CPU. ``MTTrainer.step(labeled, unlabeled)`` runs, past START_MT with
LAMBDA > 0 and an unlabeled batch, the supervised losses plus the
unlabeled consistency losses, weighted by ``weight_sum_losses``, one
backward, the clip, the SGD step and the teacher EMA; otherwise the
supervised step with its EMA gate. Nothing in a step waits on the card.
"""

from __future__ import annotations

import copy

import torch
from torch.profiler import record_function

from ..models.detector import FLAGSHIP_CONFIG, load_config, model_from_cfg, resolve_device
from .mt_step import mt_loss_weight, unlabeled_losses, weight_sum_losses
from .supervised import Trainer, batch_to_gt


class MTTrainer(Trainer):
    def __init__(self, model, teacher, cfg, gen: torch.Generator):
        super().__init__(model, cfg, gen, teacher=teacher)

    def use_mt(self, unlabeled) -> bool:
        return unlabeled is not None and self.iteration > self.mt.start_mt and self.mt.lambda_ > 0

    def step(self, labeled, unlabeled=None) -> dict:
        """One step on a labeled batch (``data.synthetic.batch_to_torch``)
        and, past START_MT, an unlabeled one (``unlabeled_to_torch``).
        Returns the unweighted losses, ``loss_total`` (their weighted sum)
        and, in a mean-teacher step, ``mt_weight``: tensors, detached."""
        with record_function("train_step"):
            if not self.use_mt(unlabeled):
                return super().step(labeled)
            losses = self.mt_losses(labeled, unlabeled)
            with record_function("loss_sum"):
                weighted = weight_sum_losses(losses, self.iteration, self.mt)
                total = sum(weighted.values())
                # a fill, not a host->device copy: the weight is a host number
                weight = torch.full((), float(mt_loss_weight(self.iteration, self.mt)), device=total.device)
            self.update(total)
            out = {k: v.detach() for k, v in losses.items()}
            out["loss_total"] = total.detach()
            out["mt_weight"] = weight
        return out

    def mt_losses(self, labeled, unlabeled) -> dict:
        """The supervised losses of ``labeled`` and the consistency losses of
        ``unlabeled`` (PLTRAIN: an unlabeled batch that carries gt feeds the
        teacher with it, generalized_rcnn.py:133-138)."""
        with record_function("mt_supervised"):
            sup = self.model.forward_train(labeled["image"], labeled["image_size"], batch_to_gt(labeled), self.gen)
        targets = batch_to_gt(unlabeled) if self.mt.pltrain and "boxes" in unlabeled else None
        mt = unlabeled_losses(self.model, self.teacher, unlabeled, self.gen, self.mt, targets=targets)
        return {**sup, **mt}


def teacher_of(model):
    """The EMA teacher's starting point: a copy of ``model`` in eval mode
    with no tensor taking a gradient (the JAX ``create_train_state(...,
    with_teacher=True)``)."""
    teacher = copy.deepcopy(model).eval()
    for t in list(teacher.parameters()) + list(teacher.buffers()):
        t.requires_grad_(False)
    return teacher


def build_mt_trainer(config_path: str = FLAGSHIP_CONFIG, device=None, seed: int = 0, opts=()) -> MTTrainer:
    """A mean-teacher trainer for the model of a YAML config (plus yacs
    ``KEY VALUE`` overrides in ``opts``): the student's weights made from
    ``seed`` as ``build_trainer`` makes them, the teacher a copy, the step's
    draws from a generator on the device seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = load_config(config_path, opts)
    model = model_from_cfg(cfg, dev, seed, train=True)
    return MTTrainer(model, teacher_of(model), cfg, torch.Generator(device=dev).manual_seed(seed))
