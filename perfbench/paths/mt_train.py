"""The mean-teacher training loop: ``train/mean_teacher.py::MTTrainer.step``
on a labeled batch and an unlabeled one (AUG_K teacher views, each with
its flip, and AUG_S student views), with the iteration counter set in the
cell's file past START_MT so that every step is a mean-teacher step. The
rest is the supervised loop's (``paths/train.py``): pinned batches copied
every step, one read of the losses, three steps in set-up that the plain
reference follows (with the teacher's EMA)."""

from __future__ import annotations

from ..harness.weights import TRAFFIC_STREAM, generator
from ..traffic import cells
from . import train


class Run(train.Run):
    MT = True

    def make_trainer(self, model, cfg, gen):
        from mmt_psm_tpu_torch.train.mean_teacher import MTTrainer, teacher_of

        tr = MTTrainer(model, teacher_of(model), cfg, gen)
        tr.iteration = self.w["iteration"]
        return tr

    def make_pool(self):
        gen = generator(self.seed, TRAFFIC_STREAM, self.dev)
        pin = self.dev.type == "cuda"
        mt = self.conf["train"]["MT"]
        k, s = mt["AUG_K"], mt["AUG_S"]
        return [{"labeled": train._pinned(cells.labeled(self.batch, self.mix, gen, self.dev), pin),
                 "unlabeled": train._pinned(cells.unlabeled(self.batch, self.mix, gen, self.dev, k, s), pin)}
                for _ in range(self.mix["pool_batches"])]

    def call(self, trainer, batch: dict):
        return trainer.step(batch["labeled"], batch["unlabeled"])
