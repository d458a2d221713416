"""The supervised train step (port of ``mmt_psm_tpu/train/supervised.py:48-100``,
the MT.LAMBDA = 0 branch every flagship mean-teacher run takes before
START_MT): forward with losses, backward, SGD step. No teacher EMA here.

``build_trainer`` is the entry point: the model of a YAML config with
seeded random weights in train mode, its optimizer and schedule, and a
generator for the step's random draws, on the card unless the caller asks
for the CPU. ``Trainer.step(batch)`` makes one step and returns the loss
dict as tensors: nothing between the forward and the optimizer step waits
on the card, so read the losses after the step.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models.detector import FLAGSHIP_CONFIG, load_config, model_from_cfg, resolve_device
from ..structures.detections import GroundTruth
from .optim import clip_grad_norm_, clip_tensors, make_optimizer


class Trainer:
    def __init__(self, model, cfg, gen: torch.Generator):
        self.model = model.train()
        self.cfg = cfg
        self.gen = gen
        self.optimizer, self.scheduler = make_optimizer(model, cfg)
        self.max_norm = float(cfg.SOLVER.CLIP_GRAD_NORM or 0.0)
        self.clip_tensors = clip_tensors(model)

    def step(self, batch) -> dict:
        """One forward, backward and SGD step on a batch of device tensors
        (``data.synthetic.batch_to_torch``). Returns the losses and their
        sum ``loss_total``, detached."""
        gt = GroundTruth(boxes=batch["boxes"], labels=batch["labels"], valid=batch["gt_valid"],
                         masks=batch["masks"])
        losses = self.model.forward_train(batch["image"], batch["image_size"], gt, self.gen)
        total = sum(v.float() for v in losses.values())
        for t in self.clip_tensors:
            t.grad = None
        # the labels name the phases in a torch.profiler trace (scripts/profile_torch_port.py --train)
        with record_function("backward"):
            total.backward()
        with record_function("optimizer_step"):
            if self.max_norm > 0:
                clip_grad_norm_(self.clip_tensors, self.max_norm)
            self.optimizer.step()
        self.scheduler.step()
        out = {k: v.detach() for k, v in losses.items()}
        out["loss_total"] = total.detach()
        return out


def build_trainer(config_path: str = FLAGSHIP_CONFIG, device=None, seed: int = 0, opts=()) -> Trainer:
    """A trainer for the model of a YAML config (plus yacs ``KEY VALUE``
    overrides in ``opts``): weights made from ``seed`` as ``build_model``
    makes them, the step's draws from a generator on the device seeded
    with ``seed``."""
    dev = resolve_device(device)
    cfg = load_config(config_path, opts)
    model = model_from_cfg(cfg, dev, seed)
    return Trainer(model, cfg, torch.Generator(device=dev).manual_seed(seed))
