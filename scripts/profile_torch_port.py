"""Where the time goes in the port's flagship forward, on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--batch 4] [--iters 10] [--out FILE]

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
  * the card's name and power limit.
With ``--out`` the JSON is also written to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the record_function labels of MaskRCNN.forward_test, in the forward's order
STAGES = ("backbone", "rpn_head", "rpn_select_proposals", "box_head", "relation_nms", "mask_head",
          "mask_relation_ciam")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 2

    from mmt_psm_tpu_torch import build_model

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    model = build_model(device=dev, seed=0)
    c = model.config
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.batch, c.image_size, c.image_size, 3, generator=gen, device=dev) * 40.0
    sizes = torch.full((args.batch, 2), c.image_size, dtype=torch.int32, device=dev)

    def forward_run(dev_ms, host_ms):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.record()
        model(x, sizes)
        e.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(s.elapsed_time(e))

    for _ in range(2):
        forward_run([], [])
    dev_ms, host_ms = [], []
    for _ in range(args.iters):
        forward_run(dev_ms, host_ms)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.iters):
            model(x, sizes)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    # a CPU-side label's device time is the sum of the kernels launched inside it
    stages = {e.key: dev_us(e) / 1e3 / args.iters for e in prof.key_averages()
              if e.key in STAGES and not str(e.device_type).endswith("CUDA")}
    # device-side events only (a CPU op's device time repeats its kernels'),
    # without the labels' own device-side annotation spans
    kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.key not in STAGES]
    rows = sorted(((e.key, dev_us(e), e.count) for e in kern if dev_us(e) > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    result = {
        "card": card,
        "batch": args.batch,
        "canvas": c.image_size,
        "dtype": c.compute_dtype,
        "stages_ms": {k: stages.get(k, 0.0) for k in STAGES},
        "unlabelled_ms": busy_us / 1e3 / args.iters - sum(stages.values()),
        "forward_ms": statistics.median(dev_ms),
        "forward_host_ms": statistics.median(host_ms),
        "patches_per_s": args.batch * 1e3 / statistics.median(host_ms),
        "device_busy_share": busy_us / wall_us,
        "profiled_wall_ms_per_forward": wall_us / 1e3 / args.iters,
        "kernels": [{"name": k[:90], "device_ms": us / 1e3 / args.iters, "count": n // args.iters}
                    for k, us, n in rows[:15]],
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
