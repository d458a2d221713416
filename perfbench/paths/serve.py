"""The serving loop: closed, one batch ahead, through the program's device
stage (``engine/inference.py::DeviceStage``) as ``run_inference`` drives it:
``dispatch`` of batch i + 1, then ``fetch`` of batch i. Each batch is
``batch`` raw uint8 canvases from a pool made in set-up and held in pinned
host memory, so the copy to the card stays in the window; detections and
float16 mask probabilities come back to the host.

A batch's latency runs from its ``dispatch`` call to the return of its
``fetch``. The outputs of a sample of the window's batches, drawn from the
seed, are checked against the plain reference once the window has closed
(``perfbench/judge/detections.py``).
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

import numpy as np
import torch

from ..counts.models import count
from ..harness import device as D, recorders
from ..harness.reading import TraceReading
from ..harness.weights import SAMPLE_STREAM, TRAFFIC_STREAM, fill, generator
from ..judge import detections as judge
from ..traffic import cells
from .program import program_model


class Run:
    def __init__(self, workload: dict, conf: dict, mix: dict, seed: int, device, t0: float):
        self.w, self.conf, self.mix, self.seed, self.dev, self.t0 = workload, conf, mix, seed, device, t0
        self.batch = workload["batch"]
        self.attempted = self.failed = 0

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from mmt_psm_tpu_torch.engine.inference import DeviceStage
        from mmt_psm_tpu_torch.ops import kernels

        if self.dev.type == "cuda":
            kernels.build_all()
        self.net = fill(program_model(self.conf, self.dev), self.seed, self.conf["init"])
        gen = generator(self.seed, TRAFFIC_STREAM, self.dev)
        n = self.mix["pool_batches"] * self.batch
        pool = cells.windows(n, self.mix, gen, self.dev)
        self.host = torch.empty(pool.shape, dtype=torch.uint8, pin_memory=self.dev.type == "cuda")
        self.host.copy_(pool)
        del pool
        h, w = self.mix["window"]
        self.sizes = np.tile(np.array([[h, w]], np.int32), (self.batch, 1))
        self.pool = [{"image": self.host[i * self.batch:(i + 1) * self.batch].numpy(), "image_size": self.sizes}
                     for i in range(self.mix["pool_batches"])]
        self.stage = DeviceStage(self.net)
        self._loop(self.w["warmup"])
        D.sync(self.dev)
        self.setup_s = time.perf_counter() - self.t0
        D.reset_peak(self.dev)

    def _loop(self, batches=None, seconds=None, keep=None, label=None):
        """Closed loop, one batch ahead, over ``batches`` batches or until
        ``seconds`` have passed. Returns per batch (dispatch start, dispatch
        end, fetch end) and hands each fetched batch to ``keep``."""
        from torch.profiler import record_function

        def span(name):
            return record_function(name) if label else contextlib.nullcontext()

        times, pending, i = [], None, 0
        start = time.perf_counter()
        while True:
            go = (i < batches) if batches is not None else (time.perf_counter() - start < seconds)
            nxt = None
            if go:
                t = time.perf_counter()
                with span("perfbench.dispatch"):
                    nxt = (i, self.stage.dispatch(self.pool[i % len(self.pool)]), t, time.perf_counter())
                i += 1
            if pending is not None:
                j, handle, td, te = pending
                with span("perfbench.fetch"):
                    out = self.stage.fetch(handle)
                times.append((td, te, time.perf_counter()))
                if keep is not None:
                    keep(j, out)
            if nxt is None:
                return times
            pending = nxt

    # -- the measured window ----------------------------------------------
    def window(self, seconds: float):
        pools = self.mix["pool_batches"]
        rng = np.random.default_rng([self.seed % (1 << 63), SAMPLE_STREAM])
        self.kept, seen = {}, [0] * pools

        def keep(j, out):  # for each pool batch, one of its window batches, drawn from the seed
            p = j % pools
            seen[p] += 1
            if rng.integers(0, seen[p]) == 0:
                self.kept[p] = out

        t = time.perf_counter()
        self.times = self._loop(seconds=seconds, keep=keep)
        D.sync(self.dev)
        self.window_s = time.perf_counter() - t
        self.memory_peak_bytes = D.peak(self.dev)
        self.attempted = len(self.times) * self.batch

    def end_to_end(self) -> dict:
        lat = [(f - d) * 1e3 for d, _, f in self.times]
        return {
            "patches_per_s": len(self.times) * self.batch / self.window_s,
            "batch_p95_ms": statistics.quantiles(lat, n=100, method="inclusive")[94] if len(lat) > 1 else lat[0],
            "peak_mem_gib": self.memory_peak_bytes / 2**30,
            "setup_s": self.setup_s,
        }

    # -- the traced segment of a --trace 1 run ----------------------------
    def traced_segment(self) -> TraceReading:
        from torch.profiler import ProfilerActivity, profile

        n = self.w["trace_batches"]
        with recorders.kernel_calls() as calls:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                self._loop(batches=n, label=True)
                D.sync(self.dev)
        return TraceReading(
            events=prof.events(), calls=calls, units=n, first="perfbench.dispatch", last="perfbench.fetch",
            window_units=len(self.times), window_s=self.window_s,
            flops_per_unit=sum(count(self.conf["flops"], self.conf["model"], self.batch).values()),
            enqueue_ms=[(e - s) * 1e3 for s, e, _ in self.times],
        )

    # -- the check --------------------------------------------------------
    def free(self):
        del self.stage, self.net
        gc.collect()
        D.empty_cache(self.dev)

    def check(self) -> dict:
        return judge.check(self.conf, self.seed, self.dev, sorted(self.kept.items()), self.host, self.sizes,
                           self.batch, self.w["check"])

