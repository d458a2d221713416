"""Readings that a cell's limits are set from, and its control.

    python3 perfbench/control.py --workload <name> --seeds 1 2 ... --control-seeds 7 8 9 [--seconds 2] [--out F]

For each of ``--seeds`` the program runs the cell as a run of the benchmark
does (set-up, for serving a short window at the cell's load and the
check's sample of its batches; for training the three steps the reference
follows) and the judge's numbers are read. For each of ``--control-seeds``
the control takes the program's place: the plain reference with its
convolutions and linear layers computed from float8 operands
(``reference/lower.py``), the step below the configuration's bfloat16, run
on the cell's own batches of the same traffic and judged the same way. In
a training cell the same seeds also read the faults planted in the
reference put in the program's place: half of each batch left out (the
losses the mean over the rest), one leaf's gradient doubled where the step
produces it, and in a mean-teacher cell one pseudo-label of each image
moved where the teacher produces it. The control has to fail a limit that the program's
readings keep. Besides the judge's numbers, a training row gives the worst
step's loss gap and the median leaf's gaps. The runs of the benchmark
itself never run this.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# the leaf whose gradient the planted fault doubles
GRADIENT_LEAF = "roi_heads.mask.predictor.mask_fcn_logits.weight"


def control_served(conf, mix, w, seed, device):
    """The control's outputs, as served batches [(pool index, outputs)], and
    the pool of canvases it ran on."""
    import numpy as np
    import torch

    from perfbench.harness.weights import TRAFFIC_STREAM, fill, generator
    from perfbench.reference import serve as RS
    from perfbench.reference.build import reference_model
    from perfbench.reference.lower import to_fp8
    from perfbench.traffic import cells

    b = w["batch"]
    net = to_fp8(fill(reference_model(conf["model"], device), seed, conf["init"]).eval())
    gen = generator(seed, TRAFFIC_STREAM, device)
    host = cells.windows(mix["pool_batches"] * b, mix, gen, device).cpu()
    h, wd = mix["window"]
    sizes = np.tile(np.array([[h, wd]], np.int32), (b, 1))
    served = []
    for j in range(mix["pool_batches"]):
        d, _ = RS.detect(net, host[j * b:(j + 1) * b].to(device), torch.from_numpy(sizes).to(device))
        served.append((j, (d.boxes.cpu().numpy(), d.scores.cpu().numpy(), d.labels.cpu().numpy(),
                           d.valid.cpu().numpy(), d.masks.to(torch.float16).cpu().numpy())))
    del net
    return served, host, sizes


def program_reading(w, conf, mix, seed, device, seconds):
    from perfbench.judge import detections as J
    from perfbench.paths.serve import Run

    run = Run(w, conf, mix, seed, device, time.perf_counter())
    run.setup()
    run.window(seconds)
    run.free()
    net = J.reference_net(conf, seed, device)
    t = J.tally(net, sorted(run.kept.items()),
                lambda p: run.host[p * run.batch:(p + 1) * run.batch], run.sizes, device)
    return t


def control_reading(w, conf, mix, seed, device):
    from perfbench.judge import detections as J

    served, host, sizes = control_served(conf, mix, w, seed, device)
    net = J.reference_net(conf, seed, device)
    b = w["batch"]
    return J.tally(net, served, lambda p: host[p * b:(p + 1) * b], sizes, device)


def _train_run(w, conf, mix, seed, device):
    import importlib

    path = importlib.import_module(f"perfbench.paths.{w['path']}")
    return path.Run(w, conf, mix, seed, device, time.perf_counter())


def moved_pseudo_labels(detect):
    """``detect`` with the first pseudo-label of each image moved 24 px where
    the teacher produces it."""
    def moved(*args, **kwargs):
        d = detect(*args, **kwargs)
        boxes = d.boxes.clone()
        boxes[:, 0] += 24.0
        return dataclasses.replace(d, boxes=boxes)
    return moved


def train_reading(kind, w, conf, mix, seed, device) -> dict:
    """The judge's numbers of the program ("program"), the control
    ("control") or a planted fault ("half_batch", "gradient", and in a
    mean-teacher cell "answer") on one seed."""
    from perfbench.judge import training as J
    from perfbench.paths.train import FOLLOWED
    from perfbench.reference.lower import to_fp8

    run = _train_run(w, conf, mix, seed, device)
    if kind == "program":
        run.setup()
        run.free()
        rec = J.program_record(run)
    else:
        run.pool = run.make_pool()
        run.losses = [None] * FOLLOWED
        feed, call = run.feed, run.call
        if kind == "half_batch":
            run.feed = lambda i: {part: {k: v[: w["batch"] // 2] for k, v in b.items()} for part, b in feed(i).items()}
        elif kind == "gradient":
            def doubled(tr, batch):
                leaf = dict(tr.model.named_parameters())[GRADIENT_LEAF]
                step = tr.optimizer.step
                tr.optimizer.step = lambda *a, **k: (leaf.grad.mul_(2.0), step(*a, **k))[1]
                try:
                    return call(tr, batch)
                finally:
                    tr.optimizer.step = step
            run.call = doubled
        tr = J.reference_trainer(run, to_fp8 if kind == "control" else None)
        if kind == "answer":
            tr.teacher.detections_from_features = moved_pseudo_labels(tr.teacher.detections_from_features)
        rec = J.follow(run, tr, FOLLOWED)
        run.feed, run.call = feed, call
    nums, ref = J.judged(rec, run)
    # readings beside the judge's numbers: the worst step's loss and the median leaf
    g = J.gaps(rec, ref, J.decay_of(run))
    nums["loss_gap"] = max(g["loss"])
    nums.update({f"median_{k}_gap": statistics.median(v) for k, v in g["leaves"].items()})
    if "teacher_change" in g["leaves"]:
        nums["teacher_change_gap"] = max(g["leaves"]["teacher_change"])
    return nums


def readings(w, conf, mix, seeds, control_seeds, device, seconds, faults=True):
    out = []
    train = w["path"] != "serve"
    kinds = (("program", seeds), ("control", control_seeds))
    if train and faults:
        kinds += (("half_batch", control_seeds), ("gradient", control_seeds))
        if w["path"] == "mt_train":
            kinds += (("answer", control_seeds),)
    for kind, seed_list in kinds:
        for seed in seed_list:
            if train:
                row = {"kind": kind, "seed": seed, **train_reading(kind, w, conf, mix, seed, device)}
            else:
                t = (program_reading(w, conf, mix, seed, device, seconds) if kind == "program"
                     else control_reading(w, conf, mix, seed, device))
                row = {"kind": kind, "seed": seed, "images": t.images, "detections": t.total, **t.numbers()}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main(argv=None):
    import torch

    from perfbench.harness import spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    w = spec.workload(a.workload)
    rows = readings(w, spec.config(w["config"]), spec.traffic(w["traffic"]), a.seeds, a.control_seeds,
                    torch.device("cuda", 0), a.seconds)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows, "card": torch.cuda.get_device_name(0)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
