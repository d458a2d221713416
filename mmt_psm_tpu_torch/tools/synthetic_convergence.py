"""From-scratch convergence on synthetic cells (the port's copy of
``scripts/synthetic_convergence.py``).

    python -m mmt_psm_tpu_torch.tools.synthetic_convergence [--iters 300] [--size 256] [--batch 4]
        [--lr 2.5e-4] [--out F] [--device cpu]

Shows that the whole stack learns: the lift's plain Mask R-CNN
(``mt_lift_experiment.LIFT_MODEL``, bf16) takes ``--iters`` supervised
steps from the seeded init on the 8 windowed slides of seed 0, the first
step on the loader's first batch, and is then scored on 2 held-out slides
of seed 99 by ``run_inference`` and Papeval. A step's losses are read after
it; a non-finite one raises ``FloatingPointError`` with the iteration. The
JSON written to ``--out`` holds the JAX script's keys (on a card also
``card``: its name and power limit). Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="supervised convergence on synthetic cells")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "synth_convergence.json"))
    ap.add_argument("--device", type=str, default=None, help="torch device; default: the card")
    return ap.parse_args(argv)


def convergence_config(args):
    """The JAX script's solver: its LR, STEPS at 0.7 of the run and a warm-up
    of min(100, iters / 5)."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.SOLVER.BASE_LR = args.lr
    cfg.SOLVER.STEPS = (int(args.iters * 0.7),)
    cfg.SOLVER.WARMUP_ITERS = min(100, args.iters // 5)
    return cfg


def main(argv=None) -> dict:
    from ..data.loader import make_source_loader, make_test_loader
    from ..data.pap import synthetic_slide_dataset
    from ..engine.inference import run_inference
    from ..models.detector import resolve_device
    from ..train import Trainer
    from .mt_lift_experiment import MAX_GT, STEP_SEED, build_model, init_model

    args = parse_args(argv)
    device = resolve_device(args.device)
    size = args.size
    model = init_model(build_model(size)[0], 0).to(device)
    train_ds = synthetic_slide_dataset(seed=0, num_slides=8, slide_size=2 * size, win_size=size, overlap=0.5)
    val_ds = synthetic_slide_dataset(seed=99, num_slides=2, slide_size=2 * size, win_size=size, overlap=0.0,
                                     is_train=False)
    print(f"train windows: {len(train_ds)}, val windows: {len(val_ds)}", flush=True)

    loader = make_source_loader(train_ds, args.batch, size, max_gt=MAX_GT, min_size=size, seed=0)
    trainer = Trainer(model, convergence_config(args), torch.Generator(device=device).manual_seed(STEP_SEED))
    t0 = time.time()
    for i in range(args.iters):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in next(loader).items()}
        losses = trainer.step(batch)
        values = torch.stack([v.float() for v in losses.values()]).cpu().tolist()
        named = dict(zip(losses, values))
        if not all(math.isfinite(v) for v in values):
            raise FloatingPointError(f"iteration {i}: the run diverged: {named}")
        if i % 25 == 0:
            print(i, {k: round(v, 3) for k, v in named.items()}, flush=True)
    train_time = time.time() - t0

    model.eval()
    loader_val = make_test_loader(val_ds, args.batch, size, max_gt=MAX_GT, min_size=size, raw_u8=True)
    stats, timing = run_inference(model, loader_val)
    result = {
        "iters": args.iters,
        "train_seconds": round(train_time, 1),
        "sec_per_iter": round(train_time / args.iters, 3),
        "AJI": {str(k): round(v, 4) for k, v in stats["AJI"].items()},
        "F1": {str(k): round(v, 4) for k, v in stats["F1"].items()},
        "mAP_all": round(stats["mAP"].get("all", -1), 4),
        "AP50_all": round(stats["AP50"].get("all", -1), 4),
        "eval_images_per_sec": round(timing["images_per_sec"], 2),
    }
    if device.type == "cuda":
        from ..utils.env import card_line

        result["card"] = card_line()
    print(json.dumps(result, indent=2))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
