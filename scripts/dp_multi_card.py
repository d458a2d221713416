"""Data-parallel training and the sharded evaluation across the cards of one host, over NCCL.

    python3 scripts/dp_multi_card.py [--world 4] [--batch 2 * WORLD]

``chip_smoke.py``'s ``data parallel`` phase (``chip_smoke.data_parallel_path``)
with one rank on each of cuda:0 .. cuda:W-1 joined over NCCL, where the smoke
runs two ranks sharing cuda:0 over gloo. The flagship at full width (1024
canvas, seed-0 weights) on a global batch of ``--batch`` images, by default 2
a rank as in the smoke. At 1 image a rank (world 4, batch 4) the f32 check
misses its bound by 2% on one tensor, as it does with 4 gloo ranks on one
card, while the losses agree within 1.1e-7; the box head's matrix products
at 512 rows are not bit-equal to those at 2048 (PERF.md §6).

* f32: one supervised step at START_MT and one MT step at the ramp's plateau,
  held against the same step of one process on the global batch (losses and
  every updated tensor to ``chip_smoke.LOSS_RTOL``, the ranks bit-identical);
* bf16: one recorded step of each kind (rank 0's kernel calls held against
  their plain versions and timed), then ``chip_smoke.DP_STEPS`` timed steps of
  each, their K1/K2/K3 launches a rank, the labeled images/s and the NCCL
  all-reduce of the gradient bucket;
* the sharded ``run_inference`` over 8 windows against one process's stats.

Before the world starts, the same bf16 steps on cuda:0 alone at the global
batch, for the comparison. Prints the cards' names and power limits
(``nvidia-smi``), the phase's lines, and last one JSON object with the
rates. Needs W cards; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (the spawned ranks import it from the repo root)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4, help="ranks, one a card")
    ap.add_argument("--batch", type=int, default=None, help="the global batch (default 2 a rank)")
    args = ap.parse_args(argv)
    batch = args.batch or 2 * args.world
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
        print(f"dp_multi_card: needs {args.world} CUDA devices, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    for line in cards:
        print(line, flush=True)
    from mmt_psm_tpu_torch.ops import kernels
    from mmt_psm_tpu_torch.parallel.mesh import Mesh

    t = time.perf_counter()
    kernels.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    one = chip_smoke._dp_bf16(dev, Mesh(1, 0, dev, None), (), batch)
    steps = chip_smoke.DP_STEPS
    one_rate = {k: steps * batch / one[k]["seconds"] for k in ("sup", "mt")}
    for kind in ("sup", "mt"):
        print(f"one card, {kind}: {steps} bf16 steps of {batch} labeled images in {one[kind]['seconds']:.3f} s, "
              f"{one_rate[kind]:.3f} labeled images/s, launches {json.dumps(one[kind]['launches'])}", flush=True)
    torch.cuda.empty_cache()
    stats = {k: {} for k in ("nms", "roi_align", "roi_align_backward")}
    t = time.perf_counter()
    ranks = chip_smoke.data_parallel_path(dev, stats, backend="nccl",
                                          devices=[f"cuda:{r}" for r in range(args.world)], batch=batch)
    wall = time.perf_counter() - t
    dp = [o["bf16"] for o in ranks]
    world_rate = {k: steps * batch / max(b[k]["seconds"] for b in dp) for k in ("sup", "mt")}
    out = {
        "cards": cards,
        "world": args.world,
        "batch": batch,
        "images_per_rank": dp[0]["images_per_rank"],
        "one_card_labeled_images_per_s": one_rate,
        "world_labeled_images_per_s": world_rate,
        "allreduce_ms": [b["allreduce"]["ms"] for b in dp],
        "allreduce_elements": dp[0]["allreduce"]["elements"],
        "launches_rank0": {k: dp[0][k]["launches"] for k in ("sup", "mt")},
        "phase_seconds": wall,
    }
    print(f"{args.world} cards over NCCL: supervised {world_rate['sup']:.3f} and MT {world_rate['mt']:.3f} labeled "
          f"images/s for the global batch of {batch} (the slowest rank's time), against {one_rate['sup']:.3f} and "
          f"{one_rate['mt']:.3f} on one card; the gradient all-reduce "
          f"{[round(x, 3) for x in out['allreduce_ms']]} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
