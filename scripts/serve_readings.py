"""The readings that a serving cell's check limits are set from, with each
side's detections counted batch by batch.

    python3 scripts/serve_readings.py --workload serve.mask_rcnn_c4.b16 --seeds 1 2 --control-seeds 3 4 \
        [--seconds 2] [--out F]

For each of ``--seeds`` the program runs the cell (set-up, a short window,
the check's sample of its batches) and for each of ``--control-seeds`` the
float8 control takes its place at the cell's batch, both judged against the
plain reference as ``perfbench/control.py`` judges them. Beside the judge's
numbers each row gives, for every judged batch, the valid detections served
and the reference's own (a check compares something only where both sides
have detections), and ``half_unmatched``: the judge's ``unmatched`` on the
same batches with the second half of each served batch emptied, the fault
that the check has to see. Needs a CUDA device.
"""

import argparse
import json
import os
import sys

# the control's float8 rounding makes float32 temporaries the size of the
# stage-5 head's input; growable segments keep them from fragmenting the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch

    from perfbench import control
    from perfbench.harness import spec
    from perfbench.judge import detections as J

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
    if w["path"] != "serve":
        print(f"{a.workload} is not a serving cell", file=sys.stderr)
        return 2
    conf, mix, dev = spec.config(w["config"]), spec.traffic(w["traffic"]), torch.device("cuda", 0)
    torch.cuda.init()

    sides, half = [], []
    add = J.Tally.add

    def counted(self, served, ref, tf_masks):  # served and reference arrays of one judged batch
        sides.append((int(served[3].sum(1).min()), int(ref[3].sum(1).min())))
        valid = served[3].copy()
        valid[valid.shape[0] // 2:] = False  # the second half of the batch served nothing
        add(half[0], (*served[:3], valid, served[4]), ref, tf_masks)
        return add(self, served, ref, tf_masks)

    J.Tally.add = counted
    rows = []
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in seeds:
            del sides[:]
            half[:] = [J.Tally()]
            torch.cuda.reset_peak_memory_stats(dev)
            (row,) = control.readings(w, conf, mix, [seed] if kind == "program" else [],
                                      [seed] if kind == "control" else [], dev, a.seconds)
            row.update(batch=w["batch"], half_unmatched=half[0].numbers()["unmatched"],
                       served_min_per_batch=[s for s, _ in sides], reference_min_per_batch=[r for _, r in sides],
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            print(json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows, "card": torch.cuda.get_device_name(0)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
