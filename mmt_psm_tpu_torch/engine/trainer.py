"""The host training loop (port of ``mmt_psm_tpu/engine/trainer.py:46-186``,
after the reference's maskrcnn_benchmark/engine/MTtrainer.py:111-281).

``MTTrainer`` drives a train step object, ``train/mean_teacher.py::
MTTrainer`` (the student, the EMA teacher, the optimizer, the LambdaLR and
the step generator), over two batch iterators:

* both are wrapped in ``data/loader.py::prefetch`` (depth
  DATALOADER.PREFETCH_DEPTH), which also puts each batch in pinned memory
  when the step runs on the card, so the loop's copy to the card is
  ``non_blocking``;
* the supervised step up to START_MT, the MT step past it when LAMBDA > 0
  and an unlabeled iterator exists (the EMA gate is the step object's);
* the losses are read from the card once a step, one stacked copy (the
  JAX loop's single ``device_get``): the only wait on the card in a step.
  The step's gradient norm (where it clips) rides in the same copy, and a
  non-finite value raises ``FloatingPointError`` with the iteration, before
  a step on NaN weights can index with NaN boxes;
* a log line every 20 iterations and at the last, with the eta and the
  learning rate of the JAX schedule at the iteration;
* ``model_{iter:07d}`` every CHECKPOINT_PERIOD iterations past 0, and
  ``model_final`` at the end, each the step object's resume payload
  (``utils/checkpoint.py::training_state``) and the tag; past START_MT
  also the teacher as ``t_model_*`` (its ``state_dict`` under ``"model"``),
  which leaves the tag alone;
* ``resume()`` restores the tagged checkpoint in place;
* TPU.PROFILE_DIR: a ``torch.profiler`` trace of iterations
  [PROFILE_START, PROFILE_START + PROFILE_STEPS) written there; the
  loop's own host work is labelled ``loop_feed``, ``loop_read_losses`` and
  ``loop_checkpoint``, the step's in ``train/``.

Data parallelism: in a process group of W ranks (``parallel/comm.py::
init_distributed``) the mesh spans the world (``parallel/mesh.py::
mesh_size_for``, which raises where TPU.MESH_SHAPE or the batch would leave
a rank out). Every rank assembles the global batch of SOLVER.IMS_PER_BATCH
images from the loaders' seeds and keeps its rows (``shard_batch``, in the
prefetch thread), so the arrays are those of the JAX mesh; the step sums
the gradients over the ranks (``train/supervised.py``). The losses of the
one copy a step are summed over the ranks first (each rank's are its share
of the global batch's), so every rank logs the global batch's losses and
sees a non-finite one, or gradient norm, at the same iteration. Rank 0
alone writes the log file and the checkpoints, then every rank waits at a
barrier; every rank resumes from the same file.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..data.loader import prefetch
from ..parallel import comm
from ..parallel.mesh import current_mesh, mesh_size_for, replicate, shard_batch
from ..train.optim import schedule_factor
from ..utils.checkpoint import Checkpointer, restore_training_state, training_state
from ..utils.logger import setup_logger
from ..utils.metric_logger import MetricLogger


# per-step values that every rank holds alike: never summed over the ranks
REPLICATED = ("mt_weight",)


def _sharded(batches, mesh):
    for b in batches:
        yield shard_batch(b, mesh)


def _pinned(batches):
    """Numpy batches as tensors in pinned host memory (run in the prefetch
    thread, off the loop's path)."""
    for b in batches:
        yield {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in b.items()}


class MTTrainer:
    def __init__(self, steps, source_loader, unlabeled_loader=None, output_dir: str = "."):
        self.steps = steps
        self.cfg = cfg = steps.cfg
        self.mt = steps.mt
        self.device = next(steps.model.parameters()).device
        mesh_size_for(cfg, int(cfg.SOLVER.IMS_PER_BATCH), comm.get_world_size())
        self.mesh = mesh = current_mesh(self.device)
        on_card = self.device.type == "cuda"
        depth = int(cfg.DATALOADER.PREFETCH_DEPTH)

        def wrap(it):
            it = _sharded(it, mesh) if mesh.world > 1 else it
            return prefetch(_pinned(it) if on_card else it, depth)

        self.source_loader = wrap(source_loader)
        self.unlabeled_loader = wrap(unlabeled_loader) if unlabeled_loader is not None else None
        self.logger = setup_logger("mmt_psm_tpu_torch.trainer", output_dir, distributed_rank=mesh.rank)
        self.meters = MetricLogger()
        self.max_iter = int(cfg.SOLVER.MAX_ITER)
        self.checkpoint_period = int(cfg.SOLVER.CHECKPOINT_PERIOD)
        self.lr_factor = schedule_factor(cfg)
        self.ckpt = Checkpointer(output_dir)
        for module in (steps.model, steps.teacher):
            if module is not None:
                replicate(module, mesh)
        self.logger.info(f"training on {self.device}, data-parallel mesh: {mesh.world} process(es)"
                         + (f" over {mesh.backend}" if mesh.backend else ""))

    def _use_mt(self, iteration: int) -> bool:
        return self.unlabeled_loader is not None and iteration > self.mt.start_mt and self.mt.lambda_ > 0

    def _to_device(self, batch) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _sup_step(self, batch) -> dict:
        return self.steps.step(batch)

    def _mt_step(self, batch, unlabeled) -> dict:
        return self.steps.step(batch, unlabeled)

    def resume(self) -> int:
        """Restore the tagged checkpoint (reference utils/checkpoint.py:
        119-142). Returns the iteration to resume at."""
        if not self.ckpt.has_checkpoint():
            return 0
        name = self.ckpt.last_name()
        restore_training_state(self.steps, self.ckpt.load(name))
        start = self.steps.iteration
        self.logger.info(f"resumed from {name} at iteration {start}")
        return start

    def train(self, start_iter: int = 0):
        if self.steps.iteration != start_iter:
            raise ValueError(f"the step object is at iteration {self.steps.iteration}, the loop at {start_iter}")
        end = time.time()
        prof_dir = self.cfg.TPU.PROFILE_DIR
        prof_start = int(self.cfg.TPU.PROFILE_START)
        prof_stop = prof_start + int(self.cfg.TPU.PROFILE_STEPS)
        profiler = None
        for iteration, batch in enumerate(self.source_loader, start_iter):
            if iteration >= self.max_iter:
                break
            if prof_dir and iteration == prof_start and profiler is None:
                profiler = self._start_profiler()
            if profiler is not None and iteration >= prof_stop:
                self._stop_profiler(profiler, prof_dir, prof_start, iteration)
                profiler = None
            # the record_function labels name the loop's host work between
            # steps in a TPU.PROFILE_DIR trace
            use_mt = self._use_mt(iteration)
            with record_function("loop_feed"):
                batch = self._to_device(batch)
                unlabeled = self._to_device(next(self.unlabeled_loader)) if use_mt else None
            losses = self._mt_step(batch, unlabeled) if use_mt else self._sup_step(batch)
            with record_function("loop_read_losses"):
                # one copy to the host, not one per scalar; the losses summed
                # over the ranks first (the gradient norm is already the global one)
                losses = comm.global_losses(losses, REPLICATED)
                read = [v.float() for v in losses.values()]
                if self.steps.grad_norm is not None:
                    read.append(self.steps.grad_norm.float())
                values = torch.stack(read).cpu().tolist()
            named = dict(zip([*losses, "grad_norm"], values))
            if not all(math.isfinite(v) for v in values):
                raise FloatingPointError(f"iteration {iteration}: the run diverged: "
                                         + ", ".join(f"{k} {v}" for k, v in named.items() if not math.isfinite(v)))
            batch_time = time.time() - end
            end = time.time()
            self.meters.update(time=batch_time, **{k: named[k] for k in losses})

            if iteration % 20 == 0 or iteration == self.max_iter - 1:
                eta = self.meters.meters["time"].global_avg * (self.max_iter - iteration)
                self.logger.info(f"iter: {iteration}  eta: {eta:.0f}s  {self.meters}  "
                                 f"lr: {self.cfg.SOLVER.BASE_LR * self.lr_factor(iteration):.6f}")
            if self.checkpoint_period and iteration > 0 and iteration % self.checkpoint_period == 0:
                with record_function("loop_checkpoint"):
                    self.save(iteration)
        if profiler is not None:
            self._stop_profiler(profiler, prof_dir, prof_start, prof_stop)
        self.save(self.max_iter, final=True)
        return self.steps

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, prof_dir: str, first: int, stop: int) -> None:
        profiler.stop()
        os.makedirs(prof_dir, exist_ok=True)
        path = os.path.join(prof_dir, f"trace_{first:07d}_{stop:07d}.json")
        profiler.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")

    def save(self, iteration: int, final: bool = False) -> None:
        name = "model_final" if final else f"model_{iteration:07d}"
        self.ckpt.save(name, training_state(self.steps))
        if iteration > self.mt.start_mt and self.steps.teacher is not None:
            tname = "t_model_final" if final else f"t_model_{iteration:07d}"
            self.ckpt.save(tname, {"model": self.steps.teacher.state_dict(), "iteration": self.steps.iteration},
                           tag=False)
