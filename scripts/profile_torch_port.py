"""Where the time goes in the port's flagship forward or train step, on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--batch 4] [--iters 10] [--out FILE] [--train | --mt]

Runs ``mmt_psm_tpu_torch.build_model`` (configs/pap/mmt_psm_r50_fpn.yaml,
1024 canvas, bf16, seeded random weights) and prints one JSON object:
  * ``forward_ms``: median device time (CUDA events) of the whole forward,
    and ``forward_host_ms``: the host clock around it, synchronised;
  * ``stages_ms``: per forward, the device time of the kernels launched
    inside each ``record_function`` label of ``MaskRCNN.forward_test``
    (backbone, rpn_head, ...), from ``torch.profiler`` over ``--iters``
    forwards; ``unlabelled_ms`` is the kernel time outside the labels;
  * ``kernels``: the 15 device kernels with the most time per forward, and
    ``device_busy_share``: all kernel time over the profiled wall time;
  * ``port_kernels``: always, the device time and launch count per forward
    of every kernel built from the port's ``csrc/`` (K1's, K2's, K3's and
    their helpers), by kernel name, on the path's own RoIs;
  * the card's name and power limit.
With ``--train`` it runs ``mmt_psm_tpu_torch.train.build_trainer`` on
synthetic batches instead and times ``Trainer.step``: ``step_ms`` and
``step_host_ms``, ``images_per_s``, the forward's stages under
``stages_ms`` (the labels of ``MaskRCNN.forward_train``), and under
``backward_ms`` each stage's share of the backward: every autograd node is
charged to the stage of the forward op that made it (their sequence
numbers link the two in the trace), gradient accumulation into the leaves
to ``accumulate_grad``; ``optimizer_ms`` is clipping and the SGD step;
``max_memory_allocated_mb`` is ``torch.cuda.max_memory_allocated()`` over
the timed steps.
With ``--mt`` it runs ``mmt_psm_tpu_torch.train.build_mt_trainer`` from
iteration START_MT + 1 on synthetic labeled and unlabeled batches
(``generate_unlabeled_batch``) and times ``MTTrainer.step`` the same way;
its stages are the labels of the mean-teacher step (``MT_STAGES``: the
supervised part, the teacher's backbone over the 2K views, its
pseudo-labels, ``paste_integral``, the teacher's proposals and box head,
the student's backbone, the hint adaptor, PSM, MGD), the backward charged
to them, and ``optimizer_ms`` the clip, SGD step and teacher EMA.
With ``--out`` the JSON is also written to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import K1_KERNELS, K2_KERNELS, K3_KERNELS  # noqa: E402

# the record_function labels of MaskRCNN.forward_test, in the forward's order
STAGES = ("backbone", "rpn_head", "rpn_select_proposals", "box_head", "relation_nms", "mask_head",
          "mask_relation_ciam")
# MaskRCNN.forward_train's labels, and Trainer.step's around the backward and the SGD step
TRAIN_STAGES = ("backbone", "rpn_head", "rpn_loss", "rpn_select_proposals", "box_head", "relation_nms",
                "mask_head", "mask_relation_ciam")
STEP_LABELS = ("backward", "optimizer_step")
# MTTrainer.step's labels (train/mt_step.py, train/mean_teacher.py)
MT_STAGES = ("mt_supervised", "mt_teacher_backbone", "mt_teacher_pseudo_labels", "mt_paste_integral",
             "mt_teacher_box_head", "mt_student_backbone", "mt_hint_adaptor", "mt_psm", "mt_mgd")
# every record_function label of the port: a label's device-side span is no kernel
ALL_LABELS = frozenset(STAGES + TRAIN_STAGES + STEP_LABELS + MT_STAGES)
BACKWARD_NODE = "autograd::engine::evaluate_function: "
PORT_KERNELS = K1_KERNELS + K2_KERNELS + K3_KERNELS


def dev_us(e):
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def enclosing_label(e, labels):
    while e is not None:
        if e.name in labels:
            return e.name
        e = e.cpu_parent
    return None


def backward_by_stage(events, stages, time_of=dev_us):
    """Each backward node's time charged to the stage of the forward op that
    created it. A forward op records the autograd sequence number it would
    give a node; ops that create none share it with the next one that does,
    so the last forward op with a number is the creator."""
    labels = set(stages) | set(STEP_LABELS)
    creator = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD_NODE) and e.name not in labels:
            stage = enclosing_label(e, labels)
            if stage in stages:
                creator[(e.thread, e.sequence_nr)] = stage
    out = dict.fromkeys(stages, 0.0)
    out["accumulate_grad"] = out["other"] = 0.0
    for e in events:
        if e.name.startswith(BACKWARD_NODE):
            stage = creator.get((e.fwd_thread, e.sequence_nr))
            if stage is None:
                stage = "accumulate_grad" if e.name.endswith("AccumulateGrad") else "other"
            out[stage] += time_of(e)
    return out


def timed_and_profiled(run, iters):
    """Device (CUDA events) and host times of ``iters`` runs after two
    warm-up runs, then a torch.profiler trace of ``iters`` more."""
    from torch.profiler import ProfilerActivity, profile

    dev_ms, host_ms = [], []
    for i in range(iters + 2):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        if i >= 2:
            host_ms.append((time.perf_counter() - t) * 1e3)
            dev_ms.append(s.elapsed_time(e))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    return dev_ms, host_ms, prof, wall_us


def breakdown(prof, labels, iters, wall_us):
    """Per-iteration device ms of each label (a CPU-side label's device time
    is the sum of the kernels launched inside it), the top kernels and the
    device's busy share."""
    stages = {e.key: dev_us(e) / 1e3 / iters for e in prof.key_averages()
              if e.key in labels and not str(e.device_type).endswith("CUDA")}
    # device-side events only (a CPU op's device time repeats its kernels'),
    # without the labels' own device-side annotation spans, nested ones too
    kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.key not in ALL_LABELS]
    rows = sorted(((e.key, dev_us(e), e.count) for e in kern if dev_us(e) > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    port = {}
    for k, us, n in rows:
        name = next((p for p in PORT_KERNELS if re.search(rf"\b{p}\b", k)), None)
        if name:
            entry = port.setdefault(name, {"device_ms": 0.0, "count": 0})
            entry["device_ms"] += us / 1e3 / iters
            entry["count"] += n // iters
    return {
        "stages_ms": {k: stages.get(k, 0.0) for k in labels},
        "device_busy_ms": busy_us / 1e3 / iters,
        "device_busy_share": busy_us / wall_us,
        "profiled_wall_ms_per_iter": wall_us / 1e3 / iters,
        "kernels": [{"name": k[:90], "device_ms": us / 1e3 / iters, "count": n // iters} for k, us, n in rows[:15]],
        "port_kernels": port,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--train", action="store_true", help="profile the supervised train step")
    ap.add_argument("--mt", action="store_true", help="profile the mean-teacher train step")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.train or args.mt:
        from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                      unlabeled_to_torch)
        from mmt_psm_tpu_torch.train import build_mt_trainer, build_trainer

        trainer = (build_mt_trainer if args.mt else build_trainer)(device=dev, seed=0)
        c = trainer.model.config
        max_gt = int(trainer.cfg.TPU.MAX_GT)
        batches = [batch_to_torch(generate_batch(s, args.batch, image_size=c.image_size, max_instances=max_gt), dev)
                   for s in range(3)]
        step = iter(range(10**9))
        if args.mt:
            mt = trainer.mt
            unlabeled = [unlabeled_to_torch(generate_unlabeled_batch(10 + s, args.batch, image_size=c.image_size,
                                                                     aug_k=mt.aug_k, aug_s=mt.aug_s,
                                                                     max_instances=max_gt), dev) for s in range(3)]
            trainer.iteration = mt.start_mt + 1
            stages = MT_STAGES

            def run():
                i = next(step) % 3
                trainer.step(batches[i], unlabeled[i])
        else:
            stages = TRAIN_STAGES

            def run():
                trainer.step(batches[next(step) % 3])
        torch.cuda.reset_peak_memory_stats(dev)
        dev_ms, host_ms, prof, wall_us = timed_and_profiled(run, args.iters)
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
        out = breakdown(prof, stages + STEP_LABELS, args.iters, wall_us)
        labelled = out["stages_ms"]
        backward = backward_by_stage(prof.events(), stages)
        result = {
            "card": card, "batch": args.batch, "canvas": c.image_size, "dtype": c.compute_dtype,
            "step": "mean_teacher" if args.mt else "supervised",
            "step_ms": statistics.median(dev_ms),
            "step_host_ms": statistics.median(host_ms),
            "images_per_s": args.batch * 1e3 / statistics.median(host_ms),
            "stages_ms": {k: labelled[k] for k in stages},
            "backward_ms": {k: v / 1e3 / args.iters for k, v in backward.items()},
            "backward_total_ms": sum(backward.values()) / 1e3 / args.iters,
            "optimizer_ms": labelled["optimizer_step"],
            "max_memory_allocated_mb": peak_mb,
            "unlabelled_ms": out["device_busy_ms"] - sum(labelled[k] for k in stages)
            - labelled["optimizer_step"] - sum(backward.values()) / 1e3 / args.iters,
            **{k: out[k] for k in ("device_busy_share", "profiled_wall_ms_per_iter", "kernels", "port_kernels")},
        }
    else:
        from mmt_psm_tpu_torch import build_model

        model = build_model(device=dev, seed=0)
        c = model.config
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(args.batch, c.image_size, c.image_size, 3, generator=gen, device=dev) * 40.0
        sizes = torch.full((args.batch, 2), c.image_size, dtype=torch.int32, device=dev)
        dev_ms, host_ms, prof, wall_us = timed_and_profiled(lambda: model(x, sizes), args.iters)
        out = breakdown(prof, STAGES, args.iters, wall_us)
        result = {
            "card": card, "batch": args.batch, "canvas": c.image_size, "dtype": c.compute_dtype,
            "stages_ms": out["stages_ms"],
            "unlabelled_ms": out["device_busy_ms"] - sum(out["stages_ms"].values()),
            "forward_ms": statistics.median(dev_ms),
            "forward_host_ms": statistics.median(host_ms),
            "patches_per_s": args.batch * 1e3 / statistics.median(host_ms),
            "device_busy_share": out["device_busy_share"],
            "profiled_wall_ms_per_forward": out["profiled_wall_ms_per_iter"],
            "kernels": out["kernels"],
            "port_kernels": out["port_kernels"],
        }
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
