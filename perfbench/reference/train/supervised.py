"""The supervised train step: a frozen copy of the program's
``train/supervised.py`` (forward with losses, backward, clip, SGD step and
the teacher EMA where a mean-teacher trainer holds a teacher), on one
device. ``cfg`` is ``build.train_cfg``'s namespace of the configuration's
SOLVER and MT keys, not the program's config tree."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..structures.detections import GroundTruth
from .ema import ema_update_
from .mt_step import MTConfig
from .optim import clip_grad_norm_, clip_tensors, make_optimizer


def batch_to_gt(batch) -> GroundTruth:
    return GroundTruth(boxes=batch["boxes"], labels=batch["labels"], valid=batch["gt_valid"],
                       masks=batch.get("masks"))


class Trainer:
    def __init__(self, model, cfg, gen: torch.Generator, teacher=None):
        self.model = model.train()
        self.cfg = cfg
        self.gen = gen
        self.optimizer, self.scheduler = make_optimizer(model, cfg)
        self.max_norm = float(cfg.SOLVER.CLIP_GRAD_NORM or 0.0)
        self.clip_tensors = clip_tensors(model)
        self.trainable = [p for p in model.parameters() if p.requires_grad]
        self.iteration = 0
        # the last step's global gradient norm where the step clips (a tensor,
        # never read here): the training loop reads it with the losses
        self.grad_norm = None
        self.mt = MTConfig.from_cfg(cfg)
        self.teacher = teacher
        # the reference EMAs the teacher only when lambda > 0, past
        # START_MT - 10 (MTtrainer.py:195-196; JAX engine/trainer.py:85)
        self.ema_start = self.mt.start_mt - 10 if self.mt.lambda_ > 0 else None
        if teacher is not None:
            # every tensor of the JAX param tree: the frozen stem, layer1 and
            # FrozenBN tensors too, not the anchors (non-persistent buffers)
            t_sd, s_sd = teacher.state_dict(), model.state_dict()
            self.ema_pairs = (list(t_sd.values()), [s_sd[k] for k in t_sd])

    def step(self, batch) -> dict:
        """One forward, backward and SGD step on a batch of device tensors
        (``data.synthetic.batch_to_torch``). Returns the losses and their
        sum ``loss_total``, detached."""
        losses = self.model.forward_train(batch["image"], batch["image_size"], batch_to_gt(batch), self.gen)
        total = sum(v.float() for v in losses.values())
        self.update(total)
        out = {k: v.detach() for k, v in losses.items()}
        out["loss_total"] = total.detach()
        return out

    def update(self, total: torch.Tensor) -> None:
        """Backward of ``total``, the gradients summed over the ranks, clip,
        SGD step, then the teacher EMA."""
        for t in self.clip_tensors:
            t.grad = None
        # the labels name the phases in a torch.profiler trace (scripts/profile_torch_port.py --train)
        with record_function("backward"):
            total.backward()
        with record_function("optimizer_step"):
            # optax decays and carries momentum for every trainable tensor,
            # one without a gradient in this step too (the hint adaptor in a
            # supervised step): give such tensors a zero gradient, and so
            # every rank reduces the same tensors
            for p in self.clip_tensors:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.max_norm > 0:
                self.grad_norm = clip_grad_norm_(self.clip_tensors, self.max_norm)
            self.optimizer.step()
            self.scheduler.step()
            if self.teacher is not None and self.ema_start is not None and self.iteration > self.ema_start:
                ema_update_(*self.ema_pairs, self.iteration - self.ema_start, self.mt.alpha)
        self.iteration += 1
