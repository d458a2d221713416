"""The supervised training loop: ``train/supervised.py::Trainer.step`` as the
training loop drives it (``engine/trainer.py``): each step's batch copied
from pinned host memory to the card with ``non_blocking``, the step, then
one read of its losses and gradient norm. Batches come from a pool made
in set-up and cycle; the first three steps, taken in set-up on three
different batches, are the ones the plain reference follows
(``perfbench/judge/training.py``), and warm every shape the window uses.
"""

from __future__ import annotations

import gc
import time

import torch

from ..harness import device as D, recorders
from ..harness.reading import TraceReading
from ..harness.weights import STEP_STREAM, TRAFFIC_STREAM, fill, generator
from ..judge import training as judge
from ..traffic import cells
from .program import program_cfg, program_model

# the steps that set-up takes and the reference follows
FOLLOWED = 3


def _pinned(batch: dict, pin: bool) -> dict:
    out = {}
    for k, v in batch.items():
        out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        out[k].copy_(v)
    return out


class Run:
    """One run of a training cell; ``mt_train`` subclasses it."""

    MT = False

    def __init__(self, workload: dict, conf: dict, mix: dict, seed: int, device, t0: float):
        self.w, self.conf, self.mix, self.seed, self.dev, self.t0 = workload, conf, mix, seed, device, t0
        self.batch = workload["batch"]
        self.attempted = self.failed = 0

    # -- the program ----------------------------------------------------------
    def trainer(self):
        """The program's trainer: the training graph with the seed's weights."""
        cfg = program_cfg(self.conf, self.w["train_opts"])
        model = fill(program_model(self.conf, self.dev, train=True, opts=self.w["train_opts"]), self.seed,
                     self.conf["init"])
        return self.make_trainer(model, cfg, generator(self.seed, STEP_STREAM, self.dev))

    def make_trainer(self, model, cfg, gen):
        from mmt_psm_tpu_torch.train.supervised import Trainer

        return Trainer(model, cfg, gen)

    def make_pool(self):
        gen = generator(self.seed, TRAFFIC_STREAM, self.dev)
        pin = self.dev.type == "cuda"
        return [{"labeled": _pinned(cells.labeled(self.batch, self.mix, gen, self.dev), pin)}
                for _ in range(self.mix["pool_batches"])]

    def call(self, trainer, batch: dict):
        return trainer.step(batch["labeled"])

    def feed(self, i: int) -> dict:
        return {part: {k: v.to(self.dev, non_blocking=True) for k, v in b.items()}
                for part, b in self.pool[i % len(self.pool)].items()}

    def _step(self, i: int):
        """The window's call and feed: (call start, call return, losses read)."""
        batch = self.feed(i)
        t = time.perf_counter()
        out = self.call(self.tr, batch)
        te = time.perf_counter()
        read = [v.float() for v in out.values()]
        if self.tr.grad_norm is not None:
            read.append(self.tr.grad_norm.float())
        values = torch.stack(read).cpu().tolist()
        return (t, te, time.perf_counter()), dict(zip(out, values))

    # -- set-up: the program built, its first steps taken -------------------
    def setup(self):
        if self.dev.type == "cuda":
            from mmt_psm_tpu_torch.ops import kernels

            kernels.build_all()
        self.tr = self.trainer()
        self.pool = self.make_pool()
        params = [p for group in self.tr.optimizer.param_groups for p in group["params"]]
        self.names = {id(p): n for n, p in self.tr.model.named_parameters()}
        self.losses, self.pseudo = [], []
        with judge.recording_pseudo_labels(self.tr, self.pseudo):
            for i in range(FOLLOWED):
                _, values = self._step(i)
                self.losses.append(values["loss_total"])
                if i == 0:
                    self.first_buffers = judge.momentum_buffers(self.tr, params, self.names)
        self.after = {self.names[id(p)]: p.detach().cpu().clone() for p in params}
        self.teacher_after = judge.teacher_weights(self.tr, set(self.after)) if self.MT else None
        self.step_i = FOLLOWED
        D.sync(self.dev)
        self.setup_s = time.perf_counter() - self.t0
        D.reset_peak(self.dev)

    # -- the measured window ------------------------------------------------
    def _loop(self, steps=None, seconds=None):
        times, start = [], time.perf_counter()
        while (len(times) < steps) if steps is not None else (time.perf_counter() - start < seconds):
            t, _ = self._step(self.step_i)
            self.step_i += 1
            times.append(t)
        return times

    def window(self, seconds: float):
        t = time.perf_counter()
        self.times = self._loop(seconds=seconds)
        D.sync(self.dev)
        self.window_s = time.perf_counter() - t
        self.memory_peak_bytes = D.peak(self.dev)
        self.attempted = len(self.times) * self.batch

    def end_to_end(self) -> dict:
        return {
            "train_images_per_s": len(self.times) * self.batch / self.window_s,
            "peak_mem_gib": self.memory_peak_bytes / 2**30,
            "setup_s": self.setup_s,
        }

    def flops_per_step(self) -> float:
        from ..counts.flops import COUNTS

        return sum(COUNTS[self.w["flops"]](self.conf["model"], self.batch).values())

    def traced_segment(self) -> TraceReading:
        from torch.profiler import ProfilerActivity, profile, record_function

        n = self.w["trace_steps"]
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        with recorders.kernel_calls() as calls:
            with profile(activities=acts) as prof:
                for _ in range(n):
                    with record_function("perfbench.step"):
                        self._step(self.step_i)
                    self.step_i += 1
                D.sync(self.dev)
        return TraceReading(
            events=prof.events(), calls=calls, units=n, first="perfbench.step", last="perfbench.step",
            window_units=len(self.times), window_s=self.window_s, flops_per_unit=self.flops_per_step(),
            enqueue_ms=[(e - s) * 1e3 for s, e, _ in self.times],
        )

    # -- the check ----------------------------------------------------------
    def free(self):
        del self.tr
        gc.collect()
        D.empty_cache(self.dev)

    def check(self) -> dict:
        return judge.check(self, self.w["check"])
