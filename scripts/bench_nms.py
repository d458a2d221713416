"""Greedy NMS kernel K1 against an earlier version, on one NVIDIA GPU.

    python3 scripts/bench_nms.py --old OLD_NMS_CU [--out FILE]

``OLD_NMS_CU`` is an earlier ``mmt_psm_tpu_torch/csrc/nms.cu`` with the
same C entry point ``nms_suppress`` and the scratch layout the port had
before the block-wise scan ([P, N, ceil(N/64)] 64-bit words), e.g. the
parent commit's, unpacked outside git's view:

    mkdir -p _bench && git show <commit>:mmt_psm_tpu_torch/csrc/nms.cu > _bench/old_nms.cu

On problems taken as score-sorted (suppression flags only, no sort) at
the calls of the main path: the forward's RPN (20 x 1000 at 0.7, the last
4 problems valid on their first 768 rows, as P6 is), relation-NMS (8 x 90
at 0.55 and 0.5, a fifth of the rows invalid) and the train step's RPN
(20 x 2000 at 0.7), and one problem each at N = 6000 and 12000 (0.7),
each on three box sets: ``chip_smoke.py``'s random boxes, clusters of 16
boxes within 2 px (most suppressed) and boxes that never meet (all kept),
it prints one JSON object with:
  * ``calls``: per call and box set, the rows kept and, in turns old, new,
    new, old, the device time (``torch.profiler``, 20 calls after warm-up)
    of each kernel each version launches and their sum (``mean_ms`` over
    a version's turns);
  * ``variants``: per call and box set, the same times for the current
    source and for it rebuilt with one piece changed, in turns (current,
    variants, variants reversed, current): ``ffs_loop`` resolves a row
    block with one step per kept row (``__ffsll`` of the candidates, a
    shared-memory load of that row's diagonal word) instead of the
    unrolled walk over all 64 rows; ``div_always`` takes the IEEE division
    for every pair, also where the boxes do not meet;
  * ``checks``: per call and box set, old and new flags bit-identical, and
    each variant's flags identical to the current source's;
  * ``ptxas``: registers, shared memory and spills of every kernel of each
    source, as ``nvcc -Xptxas -v`` reports them;
  * the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bench_roi_align import ptxas_report, turns  # noqa: E402
from chip_smoke import CANVAS, card_line, cluster_boxes, disjoint_boxes, random_boxes  # noqa: E402
from mmt_psm_tpu_torch.ops import kernels  # noqa: E402
from mmt_psm_tpu_torch.ops.nms import kernel_scratch  # noqa: E402

# name -> problems, boxes a problem, threshold (None: relation-NMS's 0.55 and 0.5)
CALLS = {"rpn": (20, 1000, 0.7), "relation": (8, 90, None), "rpn_train": (20, 2000, 0.7),
         "n_6000": (1, 6000, 0.7), "n_12000": (1, 12000, 0.7)}
BOX_SETS = ("random", "clustered", "disjoint")
# the current nms.cu rebuilt with one piece replaced: (pattern, replacement)
VARIANTS = {
    "ffs_loop": (re.compile(r"(?<=u64 resolve_block\(u64 cand, const u64\* diag\) \{\n).*?(?=\n\}\n)", re.S),
                 "  u64 kept = 0;\n"
                 "  while (cand) {\n"
                 "    const int row = __ffsll((long long)cand) - 1;\n"
                 "    kept |= 1ull << row;\n"
                 "    cand &= (cand - 1) & ~diag[row];\n"
                 "  }\n"
                 "  return kept;"),
    "div_always": (re.compile(re.escape("  if (!(inter > 0.0f) && !(thr <= 0.0f)) return false;\n")), ""),
}


def build(name, source):
    """Compile an nms.cu source with the port's nvcc flags into a ctypes
    library under the port's ignored build directory; returns it and the
    ptxas report."""
    flags = list(kernels.NVCC_FLAGS) + ["-Xptxas", "-v"]
    digest = hashlib.sha256((source + " ".join(flags)).encode()).hexdigest()[:16]
    os.makedirs(os.path.join(kernels.BUILD_DIR, "bench"), exist_ok=True)
    base = os.path.join(kernels.BUILD_DIR, "bench", f"{name}_{digest}")
    with open(base + ".cu", "w") as f:
        f.write(source)
    proc = subprocess.run([kernels._nvcc(), *flags, "-o", base + ".so", base + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(base + ".so")
    lib.nms_suppress.argtypes = kernels.SIGNATURES["nms"]["nms_suppress"]
    lib.nms_suppress.restype = ctypes.c_int
    return lib, ptxas_report(proc.stderr)


def old_scratch(p, n):
    return torch.empty((p, n, (n + 63) // 64), dtype=torch.int64, device="cuda")


def suppress(lib, scratch, boxes, valid, thr):
    p, n = valid.shape
    out = torch.empty((p, n), dtype=torch.uint8, device=boxes.device)
    err = lib.nms_suppress(boxes.data_ptr(), valid.data_ptr(), thr.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                           p, n, kernels.stream_handle(boxes.device))
    kernels.check(err, "nms_suppress")
    return out


def problems(gen, name, box_set, dev):
    p, n, t = CALLS[name]
    canvas = 256 if name == "relation" else CANVAS
    if box_set == "random":
        boxes = random_boxes(gen, p, n, canvas, dev)
    elif box_set == "clustered":
        boxes = cluster_boxes(gen, p, n, dev)
    else:
        boxes = disjoint_boxes(gen, p, n, dev)
    valid = torch.ones(p, n, dtype=torch.bool, device=dev)
    if name.startswith("rpn"):
        valid[-4:, 768:] = False
    elif name == "relation":
        valid = torch.rand(p, n, generator=gen, device=dev) > 0.2
    thr = torch.full((p,), t, device=dev) if t is not None else torch.tensor([0.55] * 4 + [0.5] * 4, device=dev)
    return boxes.contiguous(), valid, thr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="an earlier nms.cu (the scratch layout described above)")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_nms: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(args.old) as f:
        old, old_report = build("old_nms", f.read())
    with open(os.path.join(kernels.CSRC, "nms.cu")) as f:
        new_src = f.read()
    new, new_report = build("new_nms", new_src)
    variants, reports = {}, {"old": old_report, "new": new_report}
    for name, (pattern, repl) in VARIANTS.items():
        src, count = pattern.subn(lambda _: repl, new_src)
        if count != 1:
            raise RuntimeError(f"{name}: {count} matches of its pattern in nms.cu, expected 1")
        variants[name], reports[name] = build(name, src)
    result = {"card": card_line(), "calls": {}, "variants": {}, "checks": {}, "ptxas": reports}
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, (p, n, _) in CALLS.items():
        s_old, s_new = old_scratch(p, n), kernel_scratch(p, n, dev)
        for box_set in BOX_SETS:
            boxes, valid, thr = problems(gen, name, box_set, dev)
            a, b = suppress(old, s_old, boxes, valid, thr), suppress(new, s_new, boxes, valid, thr)
            key = f"{name}_{box_set}"
            result["checks"][f"{key}_bit_identical_to_old"] = bool(torch.equal(a, b))
            fns = {"old": lambda: suppress(old, s_old, boxes, valid, thr),
                   "new": lambda: suppress(new, s_new, boxes, valid, thr)}
            result["calls"][key] = {"kept": int((valid & (b == 0)).sum()), "rows": p * n,
                                    **turns(fns, ("old", "new", "new", "old"))}
            var_fns = {"new": fns["new"], **{k: (lambda lib=lib: suppress(lib, s_new, boxes, valid, thr))
                                             for k, lib in variants.items()}}
            for k, lib in variants.items():
                result["checks"][f"{key}_{k}_identical"] = bool(torch.equal(b, suppress(lib, s_new, boxes, valid, thr)))
            result["variants"][key] = turns(var_fns, (*var_fns, *reversed(var_fns)))
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
