"""Held-out scores of saved lift-experiment checkpoints (the port's copy of
``scripts/eval_lift_checkpoint.py``).

    python -m mmt_psm_tpu_torch.tools.eval_lift_checkpoint SAVE [SAVE ...] [--size 256] [--canvas 0]
        [--batch 4] [--out F] [--device cpu]

``tools/mt_lift_experiment.py`` saves each arm's final student and teacher
before it scores them; if a run is cut off while it scores, this recovers
the arm's numbers from the saves without training again. A SAVE is
``<dir>/<name>`` (or ``<dir>/<name>.pth``): an arm's ``*_final_student``
or ``*_final_teacher``, or a loop's ``model_*`` or ``t_model_*``. Each is
scored by the lift's test-time model on the lift's 8 held-out slides,
with the lift's keys. Runs on the card unless ``--device`` names another
device.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="held-out scores of saved lift checkpoints")
    ap.add_argument("ckpts", nargs="+", help="save name(s), e.g. /tmp/mt_lift_mt/mt_final_student")
    ap.add_argument("--size", type=int, default=256)
    # model canvas (0: --size), as mt_lift_experiment's
    ap.add_argument("--canvas", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--device", type=str, default=None, help="torch device; default: the card")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from ..models.detector import resolve_device
    from ..utils.checkpoint import load_model_weights
    from .mt_lift_experiment import build_model, evaluate, held_out, load_saved_weights, val_loader

    args = parse_args(argv)
    device = resolve_device(args.device)
    size = args.size
    canvas = args.canvas or size
    eval_model = build_model(canvas, with_hint=False)[0].to(device)
    val_ds = held_out(size)
    results = {}
    for path in args.ckpts:
        name = os.path.basename(path[: -len(".pth")] if path.endswith(".pth") else path)
        load_model_weights(eval_model, load_saved_weights(path))
        results[name] = evaluate(eval_model, val_loader(args, val_ds, canvas))
        print(f"{name}: {results[name]}", flush=True)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
