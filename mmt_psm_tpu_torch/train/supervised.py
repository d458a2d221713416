"""The supervised train step (port of ``mmt_psm_tpu/train/supervised.py:48-100``,
the step every flagship mean-teacher run takes up to START_MT): forward
with losses, backward, SGD step, and the teacher EMA where a mean-teacher
trainer holds a teacher.

``build_trainer`` is the entry point: the model of a YAML config with
seeded random weights in train mode, its optimizer and schedule, and a
generator for the step's random draws, on the card unless the caller asks
for the CPU. ``Trainer.step(batch)`` makes one step and returns the loss
dict as tensors: nothing between the forward and the optimizer step waits
on the card, so read the losses after the step.

Data parallelism (a process group of W ranks, one per card, each holding
an equal block of the global batch): each rank's losses are its own
numerators over the global batch's normalizers (``parallel/comm.py``), so
``update`` sums the ranks' gradients, in one bucket, before the clip, and
every rank takes the same SGD step and EMA: the single-process step on the
global batch. ``DistributedDataParallel`` does not fit: it averages the
gradients, and it hooks ``forward``, while the steps call ``forward_train``
and the mean-teacher losses.

Two counters, as in the JAX package: ``Trainer.iteration`` (the JAX
``TrainState.step``) gates the teacher EMA and the mean-teacher step and
drives the consistency ramp; the learning rate follows the optimizer's own
update count (the ``LambdaLR``, optax's ``scale_by_schedule`` count), so a
trainer started at iteration START_MT + 1 is still at its warm-up start.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models.detector import FLAGSHIP_CONFIG, load_config, model_from_cfg, resolve_device
from ..parallel import comm
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
        # the record_function labels name the phases in a torch.profiler trace
        # (scripts/profile_torch_port.py --train; perfbench's host_ms metrics)
        with record_function("train_step"):
            losses = self.model.forward_train(batch["image"], batch["image_size"], batch_to_gt(batch), self.gen)
            with record_function("loss_sum"):
                total = sum(v.float() for v in losses.values())
            self.update(total)
            out = {k: v.detach() for k, v in losses.items()}
            out["loss_total"] = total.detach()
        return out

    def update(self, total: torch.Tensor) -> None:
        """Backward of ``total``, the gradients summed over the ranks, clip,
        SGD step, then the teacher EMA."""
        with record_function("grad_reset"):
            for t in self.clip_tensors:
                t.grad = None
        with record_function("backward"):
            total.backward()
        with record_function("optimizer_step"):
            # optax decays and carries momentum for every trainable tensor,
            # one without a gradient in this step too (the hint adaptor in a
            # supervised step): give such tensors a zero gradient, and so
            # every rank reduces the same tensors
            with record_function("grad_fill"):
                for p in self.clip_tensors:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            with record_function("grad_all_reduce"):
                comm.all_reduce_grads_(self.clip_tensors)
            if self.max_norm > 0:
                with record_function("grad_clip"):
                    self.grad_norm = clip_grad_norm_(self.clip_tensors, self.max_norm)
            with record_function("sgd_step"):
                self.optimizer.step()
                self.scheduler.step()
            if self.teacher is not None and self.ema_start is not None and self.iteration > self.ema_start:
                with record_function("ema_update"):
                    ema_update_(*self.ema_pairs, self.iteration - self.ema_start, self.mt.alpha)
        self.iteration += 1


def build_trainer(config_path: str = FLAGSHIP_CONFIG, device=None, seed: int = 0, opts=()) -> Trainer:
    """A trainer for the model of a YAML config (plus yacs ``KEY VALUE``
    overrides in ``opts``): weights made from ``seed`` as ``build_model``
    makes them (plus the MGD hint adaptor of the training graph), the
    step's draws from a generator on the device seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = load_config(config_path, opts)
    model = model_from_cfg(cfg, dev, seed, train=True)
    return Trainer(model, cfg, torch.Generator(device=dev).manual_seed(seed))
