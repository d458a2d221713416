"""Whether the four-rank data-parallel f32 check's miss comes from the rank layout or from NCCL, on one card.

    python3 scripts/dp_rank_rounding.py

At one image a rank (4 ranks, global batch 4) the f32 supervised check of
``chip_smoke.data_parallel_path`` misses its bound on one tensor over NCCL
(``scripts/dp_multi_card.py --world 4 --batch 4``). This script, on one card:

1. prints whether cuBLAS's float32 product (TF32 off) of the first 512 or 1024
   of 2048 rows is bit-equal to those rows of the full product, at the box
   head's shapes (K 12544 and 1024, N 1024 and 8), and how far a weight
   gradient summed in 4 or 2 parts moves from the one-part sum;
2. runs the same data-parallel phase with 4 gloo ranks sharing cuda:0 at a
   global batch of 4, which raises where the check misses (with each loss's
   relative difference).

Prints the card's name and power limit first. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (the spawned ranks import it from the repo root)


def products():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for k, n in ((12544, 1024), (1024, 1024), (1024, 8)):
        x = torch.randn(2048, k, device="cuda", generator=g)
        w = torch.randn(n, k, device="cuda", generator=g)
        full = torch.nn.functional.linear(x, w)
        for m in (512, 1024):
            part = torch.nn.functional.linear(x[:m], w)
            d = (part - full[:m]).abs().max().item()
            print(f"linear K {k} N {n}: rows {m} of 2048 bit-equal {torch.equal(part, full[:m])}, max diff {d:.3g}",
                  flush=True)
            gw_full = torch.ones(2048, n, device="cuda").t() @ x
            gw = sum(torch.ones(m, n, device="cuda").t() @ x[i:i + m] for i in range(0, 2048, m))
            print(f"  weight gradient as {2048 // m} sums of {m} rows: relative difference "
                  f"{((gw - gw_full).norm() / gw_full.norm()).item():.3g}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_rank_rounding: needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    products()
    from mmt_psm_tpu_torch.ops import kernels

    kernels.build_all()
    stats = {k: {} for k in ("nms", "roi_align", "roi_align_backward")}
    t = time.perf_counter()
    chip_smoke.data_parallel_path(torch.device("cuda", 0), stats, devices=["cuda:0"] * 4, batch=4)
    print(f"4 gloo ranks on one card at 1 image a rank: every check passed in {time.perf_counter() - t:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
