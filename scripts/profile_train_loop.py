"""Where the port's training loop loses time against its step, on one NVIDIA GPU.

    python3 scripts/profile_train_loop.py [--steps 8] [--run-steps 40] [--out FILE]

Builds the flagship's mean-teacher trainer (``build_mt_trainer``:
configs/pap/mmt_psm_r50_fpn.yaml, 1024 canvas, bf16, batch 4, 2 + 1 views,
seeded random weights) from iteration START_MT + 1 and the train CLI's
``--synthetic`` loaders (``tools/train_mean_teacher.py::build_data``:
256-px windows on the 1024 canvas), and times ``--steps`` MT steps five
ways, each after 2 warm-up steps, in labeled images/s. Each way starts
from the same state (``utils/checkpoint.py::training_state``, restored in
place), so the five rates time the same steps.

* ``step``: ``MTTrainer.step`` on one pair of batches already on the card,
  one synchronise after the last step (``chip_smoke.py``'s ``mt bf16``);
* ``step_read``: the same with the loop's read of the losses after every
  step (``torch.stack(...).cpu()``), so the host no longer runs ahead;
* ``loop_assembled``: ``engine/trainer.py::MTTrainer.train`` over numpy
  batches already assembled (the prefetch thread pins each and the loop
  copies it to the card), saves left out;
* ``loop_loaders``: the loop over the CLI's loaders (transforms, canvas
  padding and stacking on the prefetch threads), saves left out;
* ``loop_loaders_no_thread``: the same with DATALOADER.PREFETCH_DEPTH 0,
  every batch assembled on the loop's own thread.

Then each of the CLI's loaders alone, on the loop's thread, over
``--steps`` batches (``loader_batches_per_s``). Last, ``--run-steps`` MT
iterations of the loop over the CLI's loaders from the same state, saves
left out (``long_run``): the iterations it completed and, if the loop
stopped a diverged run, its ``FloatingPointError`` with the iteration.
Prints one JSON object with each rate and the card's name and power limit
before the long run and again after it; ``--out`` also writes each to
that file.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    from mmt_psm_tpu_torch.data.loader import make_source_loader, make_unlabeled_loader
    from mmt_psm_tpu_torch.engine.trainer import MTTrainer
    from mmt_psm_tpu_torch.tools.train_mean_teacher import build_data
    from mmt_psm_tpu_torch.train import build_mt_trainer
    from mmt_psm_tpu_torch.utils.checkpoint import restore_training_state, training_state

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--run-steps", type=int, default=40)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_loop: no CUDA device")
    steps = build_mt_trainer(device="cuda", seed=0)
    cfg, n, batch = steps.cfg, args.steps, int(steps.cfg.SOLVER.IMS_PER_BATCH)
    canvas = steps.model.config.image_size
    source_ds, unlabeled_ds, min_size = build_data(cfg, True, canvas)

    def loaders():
        return (make_source_loader(source_ds, batch, canvas, max_gt=cfg.TPU.MAX_GT, min_size=min_size,
                                   max_size=canvas),
                make_unlabeled_loader(unlabeled_ds, batch, canvas, aug_k=cfg.MT.AUG_K, aug_s=cfg.MT.AUG_S,
                                      min_size=min_size, max_size=canvas))

    src, unl = loaders()
    lab_np, unl_np = next(src), next(unl)
    tmp = tempfile.mkdtemp()
    probe = MTTrainer(steps, iter(()), None, output_dir=tmp)  # its batch copy to the card
    lab, ub = probe._to_device(lab_np), probe._to_device(unl_np)
    steps.iteration = steps.mt.start_mt + 1
    start_state = copy.deepcopy(training_state(steps))
    rates = {}

    def timed_steps(read: bool) -> float:
        restore_training_state(steps, start_state)
        for _ in range(2):
            steps.step(lab, ub)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            out = steps.step(lab, ub)
            if read:
                torch.stack([v.float() for v in out.values()]).cpu()
        torch.cuda.synchronize()
        return batch * n / (time.perf_counter() - t)

    rates["step"] = timed_steps(read=False)
    rates["step_read"] = timed_steps(read=True)

    def timed_loop(source, unlabeled, depth: int) -> float:
        restore_training_state(steps, start_state)
        cfg.DATALOADER.PREFETCH_DEPTH = depth
        loop = MTTrainer(steps, source, unlabeled, output_dir=tmp)
        loop.save = lambda *a, **k: None
        start = steps.iteration
        loop.max_iter = start + 2
        loop.train(start)  # warm-up, and the prefetch threads fill their queues
        loop.max_iter = start + 2 + n
        t = time.perf_counter()
        loop.train(start + 2)
        torch.cuda.synchronize()
        for it in (loop.source_loader, loop.unlabeled_loader):
            getattr(it, "close", lambda: None)()
        return batch * n / (time.perf_counter() - t)

    rates["loop_assembled"] = timed_loop(itertools.repeat(lab_np), itertools.repeat(unl_np), -1)
    rates["loop_loaders"] = timed_loop(*loaders(), -1)
    rates["loop_loaders_no_thread"] = timed_loop(*loaders(), 0)
    alone = {}
    for what, it in zip(("source", "unlabeled"), loaders()):
        t = time.perf_counter()
        for _ in range(n):
            next(it)
        alone[what] = n / (time.perf_counter() - t)
    result = {"labeled_images_per_s": rates, "loader_batches_per_s": alone, "steps": n, "batch": batch,
              "canvas": canvas,
              "card": card_line(), "device": torch.cuda.get_device_name(0)}

    def report():
        print(json.dumps(result), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)

    report()
    restore_training_state(steps, start_state)
    cfg.DATALOADER.PREFETCH_DEPTH = -1
    loop = MTTrainer(steps, *loaders(), output_dir=tmp)
    loop.save = lambda *a, **k: None
    start = steps.iteration
    loop.max_iter = start + args.run_steps
    result["long_run"] = {"from_iteration": start, "iterations": args.run_steps, "diverged": None}
    try:
        loop.train(start)
    except FloatingPointError as e:
        result["long_run"]["diverged"] = str(e)
    finally:
        for it in (loop.source_loader, loop.unlabeled_loader):
            getattr(it, "close", lambda: None)()
    result["long_run"]["completed"] = steps.iteration - start
    meter = loop.meters.meters.get("loss_total")
    result["long_run"]["loss_total"] = list(meter.deque) if meter is not None else []
    report()
    return result


if __name__ == "__main__":
    main()
