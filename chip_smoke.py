"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero and no result
line is printed):
  1. require CUDA and print the card's name and power limit;
  2. build the CUDA kernels from ``mmt_psm_tpu_torch/csrc``;
  3. kernel K1 (greedy NMS) against its plain version on the card, at the
     flagship's shapes and on adversarial cases (``NMS_EDGE_CASES``:
     chains whose keeps alternate across 64-row borders, one box repeated,
     no overlaps, thresholds 0 and 1, N = 1, 63, 64, 65, 2048, 6000 and
     12,000): identical keep masks, and the known greedy result where the
     case's construction gives it;
  4. kernel K2 (multi-level ROIAlign) against its plain version on the
     card at the box-head and mask-head shapes, f32 and bf16, with RoIs
     far larger than the TPU kernel's window, and at 512 channels;
  5. kernel K3 (multi-level ROIAlign backward) against its plain version
     on the card at the train step's box-head and mask-head shapes, f32
     and bf16, with oversize, border and clustered RoIs that add into the
     same cells, and on RoIs that K3's tiles must split or drop:
     on tile borders, partly outside the map, ~32 cells on P5, levels no
     RoI maps to, an all-zero cotangent; every K3 call launched twice and
     the two results bit-identical;
  6. the flagship path (configs/pap/mmt_psm_r50_fpn.yaml, 1024 canvas,
     bf16, seeded random weights) on 3 batches of 4 images through
     ``build_model``; one forward runs with synchronising calls made
     errors (no host sync); launch counts show K1 and K2 ran on every
     forward;
     one batch also in f32 with the kernels and with the plain versions,
     TF32 off, whose detections must agree (on the weights of seed
     ``F32_FLAGSHIP_SEED``, where CIAM's attention is well conditioned);
  7. the serving path (``eval bf16``): the same model saved with the
     port's ``Checkpointer``, then ``engine.inference.run_inference`` over
     8 windows of 1024 px of synthetic slides (``EVAL_SLIDES``) whose gt
     are the model's own pasted instances, every other one moved 2 px (so
     AJI and mAP are above 0), batch 4, raw uint8 canvases through pinned
     staging, host paste and Papeval in this process, in which K1 and K2
     launch twice a batch; every stat finite, AJI and mAP above 0, and
     equal to the same run scored by a pool of spawned eval workers (one
     per spare core); the C++ library built into
     ``mmt_psm_tpu_torch/_build/``, and on the first image its paste and
     Papeval stats (AJI and mAP above 0) bit-identical to their plain
     numpy versions; then the test CLI's ``main`` with ``--synthetic``
     over the saved checkpoint, whose ``result.json`` must hold the JAX
     CLI's keys; last, the host's seconds to start a Python process and
     an eval worker's modules, one process at a time;
  8. the supervised train step (``build_trainer``, same config, bf16,
     batch 4 of synthetic cells): 2 warm-up steps, one step with
     synchronising calls made errors, then 5 timed steps, in which K1
     launches once per step and K2 and K3 twice; every loss finite, the
     trainable parameters moved, the stem, layer1 and every FrozenBN tensor
     bit-unchanged;
  9. one f32 train step with the kernels, against the same step with the
     plain versions of all three and with K3's alone, TF32 off (the
     relation head's geometric gate kept off its pole, as in
     tests/test_torch_port_train_step.py): losses and every gradient agree;
 10. the mean-teacher train step (``build_mt_trainer``, same config at its
     full width: batch 4 labeled + 4 unlabeled of AUG_K = 2 teacher views
     and their flips and AUG_S = 1 student view, box-head dropout 0.5, 512
     RoIs an image) from iteration START_MT + 1: 2 warm-up steps (the last
     one's kernel calls recorded, then each held against its plain version
     on the same inputs), one step with synchronising calls made
     errors, then 5 timed steps, in which K1 launches 4 times a step, K2 6
     times (the teacher's PSM box head pools 16 view images x 512 RoIs in
     one launch) and K3 3 times; PSM, MGD and the total finite, the ramp
     weight above 0, the teacher moved by the EMA and not the student, the
     student's frozen tensors bit-unchanged, the hint adaptor moved; peak
     memory;
 11. one f32 MT step at batch 2 with the kernels, against the same step with
     the plain versions of all three and with K3's alone, at the ramp's
     plateau (START_MT + RAMPUP_STEP, where the MT losses count in full):
     losses, every gradient and the teacher's EMA move agree;
 12. the training entry point (``train CLI bf16``): the train CLI's ``main``
     with ``--synthetic`` at the flagship's full width (1024 canvas, bf16,
     batch 4, 2 + 1 views), START_MT 2, MAX_ITER 6, CHECKPOINT_PERIOD 2,
     into a temporary directory: inside its loop K1 launches 15 times, K2
     24 and K3 15 (3 supervised and 3 MT steps); the checkpoints
     model_0000002, model_0000004, t_model_0000004, model_final and
     t_model_final and the tag; every logged loss finite; final_eval.json
     with the JAX CLI's keys; then MAX_ITER 8 with ``--skip-test``, which
     must resume at iteration 6. Printed: the loop's labeled images/s over
     its warm iterations 1-5 (iteration 0 waits for the first batch)
     beside the same 2 supervised and 3 MT steps at the step rates of
     phases 8 and 10, the seconds it waited on each loader, each
     save's seconds and the checkpoints' bytes; then each training loader's
     batches/s over 3 batches of 1000-px windows at MIN_SIZE_TRAIN 800;
 13. the model variants (``variants bf16``, ``mmt_psm_tpu_torch/models/
     variants.py``: the plain Mask R-CNN with the greedy post-processor,
     set-NMS, the mask relation module's CAM and extractor variants,
     RPN_ONLY, R-50-C4, PRCNN, backbone recomputation), each at the
     flagship's width (1024 canvas, bf16, batch 4, weights from seed 0; the
     forwards of C4 and remat from ``VARIANT_FORWARD_SEEDS``):
     a forward with its kernel calls recorded and one timed with
     synchronising calls made errors, then a supervised step (the plain
     Mask R-CNN: ``run_inference`` over the eval phase's windows scored
     serially, 3 warm + 5 timed supervised steps, and 3 warm + 5 timed MT
     steps whose teacher labels through the greedy post-processor; set-NMS
     and RPN_ONLY also through ``run_inference``); K1, K2 and K3 launches
     asserted per variant (``VARIANT_LAUNCHES``: C4's RPN K1 on 4 x 6000 at
     test and 4 x 12,000 in training, its K2/K3 on one 1024-channel level;
     PRCNN's K2/K3 on four f32 image scales at P25), every loss finite,
     and every recorded kernel call held against its plain version and
     timed;
 14. ``variants f32 vs plain``: each variant at batch 2 in f32, its
     detections with the kernels and with the plain versions (valid,
     labels and head_ids identical; boxes 5e-3, scores and masks 1e-3),
     then one supervised step's losses (1e-4) and gradients (GRAD_RTOL of
     their norm; with K3 alone swapped, K3_GRAD_RTOL, for C4 and PRCNN);
 15. the datasets path (``datasets bf16``), at the flagship's width (1024
     canvas, bf16, batch 4, seed-0 weights): the serving phase's 8 windows
     with the model's own instances as gt written as a COCO-format split
     (``coco_syn`` by the catalog's ``coco_*`` convention: PNGs and an
     annotations.json of uncompressed RLE, categories 7 and 9) and as a
     Pascal VOC split (JPEGs, XML boxes named aeroplane and bicycle); the
     seed-0 weights saved as model_0000000; then, every kernel call
     recorded and each sub-run's launches counted from 0: the test CLI over
     the concatenation ``coco_syn`` + ``synthetic_val`` with TEST.VISUAL_NUM
     2 and TEST.GEN (result.json with the JAX CLI's keys, 2 overlays, a .mat
     an image), ``run_inference`` over the COCO split (its evaluated
     patches/s and ``stage_seconds``), a forward whose predictions
     ``evaluation.evaluate`` scores on the COCO split (segm and bbox, finite,
     segm AP above COCO_SEGM_AP_MIN and equal to Papeval's mAP within
     EVAL_STATS_ATOL) and on the VOC split (finite mAP), one
     ``make_tta_loader`` batch's 2 views through the forward, and 2
     supervised iterations of the train CLI on ``coco_syn`` +
     ``synthetic_train`` (finite losses, its images/s); K1 and K2 twice a
     batch or view, K1 once and K2 and K3 twice a step; every recorded call
     held against its plain version, one of each shape timed;
 16. the data-parallel path (``data parallel``), after ``datasets bf16``: two
     ranks spawned on the card over gloo (NCCL refuses two ranks on one
     device; a ``file://`` rendezvous, a 300 s group timeout, a 900 s
     deadline, every rank killed when one fails, which fails the phase), at
     the flagship's width (1024 canvas, global batch 4, 2 a rank, seed-0
     weights): in f32 (TF32 and cuDNN off), one supervised step at START_MT
     and one MT step at the ramp's plateau, each held against the same step
     of one process on the global batch, which a rank computes first with
     the world size read as 1: losses within LOSS_RTOL relative, the updated
     student and EMA teacher within LOSS_RTOL of each tensor's norm + 1e-6,
     the ranks' tensors bit-identical; in bf16, one recorded step of each
     kind (every kernel call held against its plain version, rank 0's also
     timed while rank 1 waits, K1/K2/K3 launching 1/2/2 a supervised step
     and 4/6/3 an MT step, the single card's counts), then DP_STEPS timed
     steps of each with their launches
     counted from 0, each rank's labeled images/s and the gradient
     all-reduce's ms for the ~46M-element bucket; ``run_inference`` on the
     ranks over the serving phase's 8 windows (the model's own instances as
     gt), each serving its ShardSampler share at batch 2, every rank's stats
     (AJI, F1, DSC, mAP) within EVAL_STATS_ATOL of one process's at batch 2;
     then on rank 0 a one-rank NCCL group with every helper of
     ``parallel/comm.py`` issuing its collective: a warm supervised step
     held to the same step without collectives (LOSS_RTOL), one with
     synchronising calls made errors (its all-reduces counted), the loss
     sum, ``all_gather_object`` and the barrier. NCCL at more than one rank
     does not run on one card;
 17. the learning tools (``learning bf16``), after ``data parallel``: the
     lift tool's ``main`` (``mmt_psm_tpu_torch/tools/mt_lift_experiment.py``,
     ``LEARN_LIFT``: the sup and mt arms at 256 px, batch 4, 40 iterations
     each, MT from iteration 20, 16 unlabeled patches, ``--sharpen
     --hard-neg``; each arm's loop, its scoring of the 8 held-out slides and
     the saves, in a temporary directory), then ``synthetic_convergence``'s
     ``main`` for 20 iterations; the first kernel call of each shape recorded
     (``FirstOfEachShape``) and held against its plain version and timed; each
     tool's K1/K2/K3 launches counted from 0 and each above 0; every loss of
     the loops finite (the loop raises on one that is not), each JSON with
     exactly its JAX script's keys and the card's line, every number finite;
     each arm's iterations a second;
 18. a ``{"kernels": [...]}`` line with each kernel's time over its calls
     of one flagship forward (K1: the RPN's and relation-NMS's; K2: the box
     head's and the mask head's) or of one train step (K3: the box head's
     and the mask head's), its plain version's time and its bound on this
     card, K1's and K2's launches in the serving path under
     ``launches_eval``, its launches in the datasets path under
     ``launches_datasets``, the K1 and K2 numbers of the train step under ``*_train`` keys,
     every kernel's over the MT step's recorded calls under ``*_mt``
     keys (plain times too), its launches in the train CLI's loop under
     ``launches_cli``, rank 0's launches over the data-parallel path's timed
     supervised and MT steps under ``launches_dp``, the learning path's
     launches and its recorded calls' summed times, bound and error under
     ``*_learning`` keys and, under ``variants``,
     each variant's launches,
     summed times, bound and error over its recorded calls, after lines
     with each call's own times. A
     kernel's time is the device time of the kernels its wrapper launches
     (torch.profiler), without the host's time to launch them; a plain
     version's is CUDA events around it;
 19. the throughput in patches/s, evaluated patches/s (the serving path
     scored serially, with the host seconds of each of its stages; the
     pool's run and its start on a line of its own; the datasets path's COCO
     sweep), images/s (supervised, MT, the train CLI's loop and its 2
     iterations on the concatenation), the training loaders' batches/s and
     the lift's arms' iterations/s beside the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import re
import subprocess
import sys
import time
from unittest import mock

import torch

from mmt_psm_tpu_torch.utils.env import card_line

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# (non-tensor-core) operations/s. Bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BATCH, BATCHES, CANVAS = 4, 3, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# bf16 comparison: the same f32 sum in another order, rounded once to bf16;
# f32: ATOL (the variants' calls: of the largest |value| where that passes 1)
BF16_RTOL, ATOL = 2.0**-7, 1e-5
# K3 f32: sums of up to a few hundred weighted cotangents per cell, in another
# order (the variants' calls: of the largest |gradient| where that passes 1)
K3_F32_ATOL = 1e-4
# the f32 train step with the kernels against the plain versions: the same
# arithmetic with float32 sums in other orders (K3's among them).
# The relation head's geometric gate log(max(relu(WG(pos)), 1e-6)) has a
# pole: a gate within float32 noise of 0 takes a gradient of up to 1e6, so
# the comparison sets WG's bias to WG_BIAS in both models and every gate
# sits near it. Each gradient is held by its L2 norm, ||g - g'|| <=
# rtol ||g'|| + 1e-6. With all three kernels swapped, GRAD_RTOL: where K2's
# float32 rounding puts a ReLU input of the box head on the other side of
# 0, one unit flips for one RoI, and that RoI's changed cotangent reaches
# every backbone gradient through K3. With K3 alone swapped the forward is
# the same, and only the order of K3's float32 sums differs:
# K3_GRAD_RTOL.
LOSS_RTOL, GRAD_RTOL, K3_GRAD_RTOL, WG_BIAS = 1e-4, 1e-2, 1e-4, 5.0
# the __global__ functions of csrc/*.cu that each wrapper launches
K1_KERNELS = ("nms_iou_mask_kernel", "nms_block_scan_kernel")
K2_KERNELS = ("roi_align_kernel",)
K3_KERNELS = ("roi_footprint_kernel", "roi_align_backward_kernel")
PROFILER_TRIES = 5
_PROFILER = {"fell_back": False}


def phase(name, fn):
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"[{name}] ok in {time.perf_counter() - t:.3f} s", flush=True)
    return out


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Device ms per call of each kernel and memset ``fn`` launches, by the
    profiler's name, over ``iters`` calls after warm-up (torch.profiler:
    the kernels' own time, without the host's time to launch them)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            out[e.key] = us / 1e3 / iters
    return out


def kernel_ms(fn, kernels):
    """Device ms per call of the named kernels of ``csrc/`` that ``fn`` launches.
    A trace that holds no device event at all (the profiler's activity
    buffers came back empty: seen on an H100, once and then three times in
    a row, on calls that the same process had traced right before) is taken
    again after a pause, at most PROFILER_TRIES times in all; then the call
    is timed by CUDA events (``cuda_ms``, which holds the host's launch time
    too) and a line says so. A trace that holds other kernels but none of
    these fails. After such a fallback the next call tries the profiler
    once before it falls back."""
    tries = 1 if _PROFILER["fell_back"] else PROFILER_TRIES
    for i in range(tries):
        times = device_ms(fn)
        if times:
            _PROFILER["fell_back"] = False
            break
        if i + 1 < tries:
            time.sleep(1.0)
    else:
        _PROFILER["fell_back"] = True
        ms = cuda_ms(fn)
        print(f"kernel_ms: no device event traced in {tries} tries; {kernels} timed by CUDA events: "
              f"{ms} ms", flush=True)
        return ms
    ms = sum(v for k, v in times.items() if any(re.search(rf"\b{n}\b", k) for n in kernels))
    if ms <= 0:
        raise AssertionError(f"none of {kernels} ran on the device: {sorted(times)}")
    return ms


def random_boxes(gen, b, n, canvas, dev):
    """Boxes of 8..600 px in the canvas, a tenth of them oversize or
    elongated (spanning well over 48 cells of their level) or hanging
    over the border."""
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    wh = 8 + 592 * u(b, n, 2) ** 2
    xy = u(b, n, 2) * (canvas - wh)
    boxes = torch.cat([xy, xy + wh], -1)
    k = min(max(n // 10, 4), n)
    big = torch.tensor([[-100.0, -80.0, 1200.0, 1150.0], [0.0, 500.0, 1023.0, 530.0],
                        [300.0, 0.0, 330.0, 1023.0], [-50.0, 900.0, 150.0, 1100.0]], device=dev)
    boxes[:, :k] = big.repeat(k // 4 + 1, 1)[:k]
    return boxes


def disjoint_boxes(gen, b, n, dev):
    """8-px boxes on a 10-px grid, shuffled: no two meet (+1 widths), so
    greedy NMS keeps every valid box at any threshold above 0."""
    side = math.isqrt(n - 1) + 1
    cell = torch.stack([torch.randperm(side * side, generator=gen, device=dev)[:n] for _ in range(b)]).float()
    xy = torch.stack([cell % side, cell.div(side, rounding_mode="floor")], -1) * 10.0
    return torch.cat([xy, xy + 8.0], -1)


def chain_boxes(n, start, dev):
    """[n, 4] in score order: from row ``start`` on, box i overlaps box i+1
    at IoU 2/3 and box i+2 at 3/7 (+1 areas); the rows before it lie apart.
    At a threshold of 0.5 the keeps alternate from ``start``."""
    i = torch.arange(n, dtype=torch.float32, device=dev)
    x = torch.where(i < start, -100.0 * (i + 1), 2.0 * i)
    return torch.stack([x, torch.zeros_like(x), x + 9.0, torch.full_like(x, 10.0)], -1)


# K1 cases that stress the block-wise scan (name -> P, N): chains whose
# keeps alternate, across every 64-row border in both parities; one box
# repeated; no overlaps; thresholds 0 and 1; N around one word; large N
NMS_EDGE_CASES = {
    "chain_300": (1, 300), "chain_borders_2048": (3, 2048), "chain_12000": (1, 12000),
    "identical_130": (2, 130), "disjoint_2048": (2, 2048), "thr_0": (2, 500), "thr_1": (2, 500),
    "n_1": (3, 1), "n_63": (3, 63), "n_64": (3, 64), "n_65": (3, 65), "n_2048": (3, 2048),
    "n_6000": (1, 6000), "n_12000": (1, 12000),
}


def nms_edge_case(name, gen, dev):
    """(boxes, scores, valid, thr, keep or None) of one case of
    ``NMS_EDGE_CASES``; ``keep`` is the greedy result where it is known
    from the construction."""
    p, n = NMS_EDGE_CASES[name]
    idx = torch.arange(n, device=dev)
    desc = (n - idx).float().expand(p, n).contiguous()  # scores in row order
    every = torch.ones(p, n, dtype=torch.bool, device=dev)
    if name.startswith("chain"):
        starts = (0, 1, 61)[:p]
        boxes = torch.stack([chain_boxes(n, s, dev) for s in starts])
        keep = torch.stack([(idx < s) | ((idx - s) % 2 == 0) for s in starts])
        return boxes, desc, every, 0.5, keep
    if name == "identical_130":  # equal scores: the stable order keeps row 0 alone
        boxes = torch.tensor([10.0, 20.0, 110.0, 220.0], device=dev).expand(p, n, 4).contiguous()
        return boxes, torch.ones(p, n, device=dev), every, torch.tensor([0.7, 1.0], device=dev), (idx == 0).expand(p, n)
    if name == "disjoint_2048":
        scores = torch.rand(p, n, generator=gen, device=dev)
        return disjoint_boxes(gen, p, n, dev), scores, every, torch.tensor([0.5, 0.01], device=dev), every
    boxes = random_boxes(gen, p, n, CANVAS, dev)
    scores = torch.rand(p, n, generator=gen, device=dev)
    valid = torch.rand(p, n, generator=gen, device=dev) > 0.1
    if name == "thr_0":  # every pair suppresses: the best valid box alone is kept
        first = torch.where(valid, scores, -1.0).argmax(1, keepdim=True)
        return boxes, scores, valid, 0.0, torch.zeros_like(valid).scatter(1, first, True)
    if name == "thr_1":  # only exact repeats suppress
        boxes[:, 1::3] = boxes[:, 0::3][:, : boxes[:, 1::3].shape[1]]
        return boxes, scores, valid, 1.0, None
    return boxes, scores, valid, 0.7, None


# ------------------------------------------------------------------ K1 NMS
def check_nms(dev, stats):
    from mmt_psm_tpu_torch.ops import nms as N

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    # the RPN's call: B x 5 levels padded to 1000 rows (P6 holds 768), thr 0.7
    rpn_b = random_boxes(gen, BATCH * 5, 1000, CANVAS, dev)
    rpn_s = torch.rand(BATCH * 5, 1000, generator=gen, device=dev)
    rpn_v = torch.ones(BATCH * 5, 1000, dtype=torch.bool, device=dev)
    rpn_v[-BATCH:, 768:] = False
    cases.append(("rpn", rpn_b, rpn_s, rpn_v, 0.7))
    # relation-NMS: B x 2 classes of 90, thr 0.55 then 0.5
    rel_b = random_boxes(gen, BATCH * 2, 90, 256, dev)
    rel_s = (torch.rand(BATCH * 2, 90, generator=gen, device=dev) * 8).floor() / 8  # ties
    rel_v = torch.rand(BATCH * 2, 90, generator=gen, device=dev) > 0.2
    rel_v[0] = False  # an all-invalid problem
    thr = torch.cat([torch.full((BATCH,), 0.55, device=dev), torch.full((BATCH,), 0.5, device=dev)])
    cases.append(("relation", rel_b, rel_s, rel_v, thr))
    # identical boxes and equal scores, N not a multiple of 64
    dup = random_boxes(gen, 3, 130, 300, dev)
    dup[:, 1::2] = dup[:, 0::2][:, : dup[:, 1::2].shape[1]]
    cases.append(("duplicates", dup, torch.ones(3, 130, device=dev), torch.ones(3, 130, dtype=torch.bool, device=dev), 0.5))
    # the train step's RPN call: B x 5 levels of PRE_NMS_TOP_N_TRAIN = 2000 rows (P6 holds 768), thr 0.7
    tr_b = random_boxes(gen, BATCH * 5, 2000, CANVAS, dev)
    tr_s = torch.rand(BATCH * 5, 2000, generator=gen, device=dev)
    tr_v = torch.ones(BATCH * 5, 2000, dtype=torch.bool, device=dev)
    tr_v[-BATCH:, 768:] = False
    cases.append(("rpn_train", tr_b, tr_s, tr_v, 0.7))

    worst = 0.0
    for name, b, s, v, t in cases:
        got = N.nms_mask(b, s, v, t)
        want = N.nms_mask_plain(b, s, v, t)
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"K1 {name}: {bad} keep flags differ from the plain version")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    for name in NMS_EDGE_CASES:
        b, s, v, t, keep = nms_edge_case(name, gen, dev)
        got = N.nms_mask(b, s, v, t)
        bad = int((got != N.nms_mask_plain(b, s, v, t)).sum())
        if bad:
            raise AssertionError(f"K1 {name}: {bad} keep flags differ from the plain version")
        if keep is not None and not torch.equal(got, keep):
            raise AssertionError(f"K1 {name}: keeps differ from the case's known greedy result")
    print(f"K1 identical to the plain version on {len(cases)} path cases and {len(NMS_EDGE_CASES)} edge cases "
          f"({', '.join(NMS_EDGE_CASES)})", flush=True)

    # time the kernel and its plain version on the flagship forward's two
    # calls, the RPN's and relation-NMS's, and on the train step's one call
    infer, i_bytes, i_ops = time_nms(cases[:2], dev)
    train, t_bytes, t_ops = time_nms(cases[-1:], dev)
    t_bound = bound(t_bytes, t_ops)
    stats["nms"] = dict(
        name="nms_suppress", route="cuda", source="mmt_psm_tpu_torch/csrc/nms.cu",
        replaces="mmt_psm_tpu/ops/nms_pallas.py:43", max_abs_err=worst,
        ms=sum(v[0] for v in infer.values()), plain_ms=sum(v[1] for v in infer.values()),
        **bound(i_bytes, i_ops), library_ms=None,
        ms_train=train["rpn_train"][0], plain_ms_train=train["rpn_train"][1],
        bound_ms_train=t_bound["bound_ms"], bound_by_train=t_bound["bound_by"],
    )
    print("K1 per call (kernel ms, plain ms): " + json.dumps({**infer, **train}), flush=True)


def time_nms(cases, dev):
    """Kernel and plain times of each call on score-sorted problems (flags
    only, no sort), with the bytes and operations greedy NMS needs on them."""
    from mmt_psm_tpu_torch.ops import nms as N

    per_call, nbytes, ops = {}, 0, 0.0
    for name, b, s, v, t in cases:
        order = torch.argsort(-torch.where(v, s, N.NEG_INF), dim=-1, stable=True)
        bs = torch.gather(b, 1, order[..., None].expand(-1, -1, 4)).contiguous()
        vs = torch.gather(v, 1, order)
        th = N._thresholds(t, bs.shape[0], dev)
        supp = N.suppress_plain(bs, vs, th)
        per_call[name] = (kernel_ms(lambda: N.suppress_cuda(bs, vs, th), K1_KERNELS),
                          cuda_ms(lambda: N.suppress_plain(bs, vs, th), iters=3, warmup=1))
        # least work greedy NMS needs on these data: each kept box against every later box
        n = bs.shape[1]
        kept = (~supp & vs).float()
        pairs = float((kept * (n - 1 - torch.arange(n, device=dev))).sum())
        ops += 14.0 * pairs  # max/min/sub/add/mul/div/compare of one IoU test
        nbytes += bs.numel() * 4 + vs.numel() + th.numel() * 4 + vs.numel()  # boxes, valid, thr in; flags out
    return per_call, nbytes, ops


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes > t_ops else "operations")


def sampled_cells(feats, boxes, scales, p, g):
    """Distinct (level, image, y, x) cells whose value some RoI's samples
    weigh in (the pooler's own sample arithmetic): what ROIAlign must read."""
    from mmt_psm_tpu_torch.ops import pooler as Pm

    b, n = boxes.shape[:2]
    levels = Pm._levels(boxes, scales).reshape(-1)
    img = torch.arange(b, device=boxes.device).repeat_interleave(n)
    bx = boxes.reshape(-1, 4).float()
    cells = 0
    for lv, (f, sc) in enumerate(zip(feats, scales)):
        sel = levels == lv
        r, h, w = int(sel.sum()), f.shape[1], f.shape[2]
        if r == 0:
            continue
        x0, y0 = bx[sel, 0] * sc, bx[sel, 1] * sc
        rw, rh = (bx[sel, 2] * sc - x0).clamp(min=1.0), (bx[sel, 3] * sc - y0).clamp(min=1.0)
        ylo, yhi, wylo, wyhi = Pm._axis_samples(y0, rh, p, g, torch.full((r,), float(h), device=boxes.device))
        xlo, xhi, wxlo, wxhi = Pm._axis_samples(x0, rw, p, g, torch.full((r,), float(w), device=boxes.device))
        ys, ym = torch.cat([ylo, yhi], 1), torch.cat([wylo > 0, wyhi > 0], 1)
        xs, xm = torch.cat([xlo, xhi], 1), torch.cat([wxlo > 0, wxhi > 0], 1)
        flat = (img[sel] * h * w)[:, None, None] + (ys * w)[:, :, None] + xs[:, None, :]
        occ = torch.zeros(b * h * w, dtype=torch.bool, device=boxes.device)
        occ[flat[ym[:, :, None] & xm[:, None, :]]] = True
        cells += int(occ.sum())
    return cells


# ------------------------------------------------------------ K2 ROIAlign
def check_roi_align(dev, stats):
    from mmt_psm_tpu_torch.ops import pooler as Pm

    gen = torch.Generator(device=dev).manual_seed(2)
    scales = (0.25, 0.125, 0.0625, 0.03125)
    feats32 = [torch.randn(BATCH, CANVAS // 4 >> i, CANVAS // 4 >> i, 256, generator=gen, device=dev) for i in range(4)]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    worst, timed = 0.0, {}
    for n, p in ((1000, 7), (180, 14)):
        boxes = random_boxes(gen, BATCH, n, CANVAS, dev)
        for feats, rtol in ((feats32, 0.0), (feats16, BF16_RTOL)):
            got = Pm.multilevel_roi_align(feats, boxes, scales, p, 2)
            want = Pm.multilevel_roi_align_plain(feats, boxes, scales, p, 2)
            err = (got.float() - want.float()).abs()
            excess = float((err - ATOL - rtol * want.float().abs()).max())
            if excess > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"K2 N={n} P={p} {feats[0].dtype}: max err {float(err.max())}")
            if feats is feats32:
                worst = max(worst, float(err.max()))
        timed["box_head" if p == 7 else "mask_head"] = (boxes, p)
    # twice the FPN's width: a block's lanes loop over two 256-channel chunks
    wide = [torch.randn(2, CANVAS // 4 >> i, CANVAS // 4 >> i, 512, generator=gen, device=dev) for i in range(4)]
    boxes = random_boxes(gen, 2, 180, CANVAS, dev)
    for feats, rtol in ((wide, 0.0), ([f.to(torch.bfloat16) for f in wide], BF16_RTOL)):
        got = Pm.multilevel_roi_align(feats, boxes, scales, 7, 2)
        want = Pm.multilevel_roi_align_plain(feats, boxes, scales, 7, 2)
        err = (got.float() - want.float()).abs()
        if float((err - ATOL - rtol * want.float().abs()).max()) > 0:
            raise AssertionError(f"K2 C=512 {feats[0].dtype}: max err {float(err.max())}")
    del wide
    # time the kernel and its plain version on the flagship forward's two
    # calls, the box head's and the mask head's, and on the train step's two
    # (512 sampled RoIs per image at P = 7, 128 mask RoIs at P = 14), in bf16
    infer, i_bound = time_roi_align(feats16, timed, scales)
    train, t_bound = time_roi_align(feats16, {"box_head_train": (random_boxes(gen, BATCH, 512, CANVAS, dev), 7),
                                              "mask_head_train": (random_boxes(gen, BATCH, 128, CANVAS, dev), 14)},
                                    scales)
    stats["roi_align"] = dict(
        name="roi_align_forward", route="cuda", source="mmt_psm_tpu_torch/csrc/roi_align.cu",
        replaces="mmt_psm_tpu/ops/roi_align_pallas.py:92", max_abs_err=worst,
        ms=sum(v[0] for v in infer.values()), plain_ms=sum(v[1] for v in infer.values()),
        **i_bound, library_ms=None,
        ms_train=sum(v[0] for v in train.values()), plain_ms_train=sum(v[1] for v in train.values()),
        bound_ms_train=t_bound["bound_ms"], bound_by_train=t_bound["bound_by"],
    )
    print("K2 per call (kernel ms, plain ms): " + json.dumps({**infer, **train}), flush=True)


def time_roi_align(feats, calls, scales):
    """Kernel and plain times of each call, with the bound of all of them."""
    from mmt_psm_tpu_torch.ops import pooler as Pm

    per_call, nbytes, ops = {}, 0, 0.0
    for name, (boxes, p) in calls.items():
        per_call[name] = (kernel_ms(lambda: Pm.multilevel_roi_align_cuda(feats, boxes, scales, p, 2), K2_KERNELS),
                          cuda_ms(lambda: Pm.multilevel_roi_align_plain(feats, boxes, scales, p, 2),
                                  iters=3, warmup=1))
        out_elems = boxes.shape[0] * boxes.shape[1] * p * p * 256
        # the cells the samples read, boxes and levels in, the pooled features out
        nbytes += sampled_cells(feats, boxes, scales, p, 2) * 256 * 2 + boxes.numel() * 5 + out_elems * 2
        ops += out_elems * 4 * (4 * 2 + 2)  # 4 samples x (4 corner mul-adds + 2 row weights)
    return per_call, bound(nbytes, ops)


# ------------------------------------------------- K3 ROIAlign backward
def cluster_boxes(gen, b, n, dev):
    """n RoIs in clusters of 16 boxes within 2 px of each other, so that
    K3 adds many RoIs' cotangents into the same gradient cells."""
    centres = random_boxes(gen, b, n // 16 + 1, CANVAS, dev)
    boxes = centres.repeat_interleave(16, dim=1)[:, :n]
    return boxes + 2.0 * torch.rand(b, n, 4, generator=gen, device=dev)


def edge_boxes(dev):
    """RoIs that K3's tiles must split or drop right, [24 + 8, 4]
    on the canvas: 24 level-0 RoIs whose samples straddle tile borders
    (tiles are 16 px apart there), RoIs partly or mostly outside the map,
    and RoIs of ~32 cells on P5 (8 tiles a side) and ~20 on P4."""
    k = torch.arange(24, dtype=torch.float32, device=dev)
    x0, y0 = 32.0 * (k % 6 + 1) - 2.0 + 0.25 * (k % 4), 32.0 * (k // 6 + 1) - 1.0
    border = torch.stack([x0, y0, x0 + 29.0 + k, y0 + 31.0], -1)
    other = torch.tensor([[-40.0, -30.0, 60.0, 50.0], [980.0, 990.0, 1100.0, 1080.0], [-300.0, 400.0, 200.0, 700.0],
                          [700.0, -500.0, 1300.0, 300.0], [-900.0, -900.0, 1900.0, 1900.0], [0.0, 0.0, 1023.0, 1023.0],
                          [10.0, 20.0, 1000.0, 990.0], [100.0, 60.0, 420.0, 380.0]], device=dev)
    return torch.cat([border, other])


def k3_against_plain(g, boxes, shapes, scales, p, sampling, what, scaled=False):
    """K3 launched twice (bit-identical) and held to its plain version;
    returns the largest difference. ``scaled``: the f32 bound is
    K3_F32_ATOL of the largest |gradient| where that passes 1."""
    from mmt_psm_tpu_torch.ops import pooler as Pm

    got = Pm.multilevel_roi_align_backward_cuda(g, boxes, shapes, scales, p, sampling)
    again = Pm.multilevel_roi_align_backward_cuda(g, boxes, shapes, scales, p, sampling)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K3 {what} {g.dtype}: two launches on the same inputs differ")
    want = Pm.multilevel_roi_align_backward_plain(g, boxes, shapes, scales, p, sampling)
    used = set(Pm._levels(boxes, scales).flatten().tolist())
    worst = 0.0
    for lv, (a, b) in enumerate(zip(got, want)):
        if a.dtype != g.dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"K3 {what} level {lv}: {a.dtype} {tuple(a.shape)} or non-finite")
        if (lv not in used or not g.any()) and a.any():
            raise AssertionError(f"K3 {what} level {lv}: no cotangent reaches it, yet it is not all zero")
        err = float((a.float() - b.float()).abs().max())
        ref = float(b.float().abs().max())
        # f32: the same sums as the plain index_add_, in another order;
        # bf16: that f32 sum rounded once, so one bf16 rounding step at most
        f32_atol = K3_F32_ATOL * max(1.0, ref) if scaled else K3_F32_ATOL
        ok = err <= f32_atol if g.dtype == torch.float32 else err <= BF16_RTOL * ref
        if not ok:
            raise AssertionError(f"K3 {what} {g.dtype} level {lv}: max err {err} (max |ref| {ref})")
        worst = max(worst, err)
    return worst


def check_roi_align_backward(dev, stats):
    from mmt_psm_tpu_torch.ops import pooler as Pm

    gen = torch.Generator(device=dev).manual_seed(5)
    scales = (0.25, 0.125, 0.0625, 0.03125)
    shapes = [(BATCH, CANVAS // 4 >> i, CANVAS // 4 >> i, 256) for i in range(4)]
    edges = edge_boxes(dev).expand(BATCH, -1, -1).contiguous()
    for what, boxes, zero in (("tile edges", edges, False), ("levels 1-3 empty", edges[:, :24].contiguous(), False),
                              ("zero cotangent", edges, True)):
        g = torch.randn(BATCH, boxes.shape[1], 7, 7, 256, generator=gen, device=dev) * (0.0 if zero else 1.0)
        for gd in (g, g.to(torch.bfloat16)):
            k3_against_plain(gd, boxes, shapes, scales, 7, 2, what)
    worst, per_call, nbytes, ops = 0.0, {}, 0, 0.0
    # the train step's two calls: 512 sampled RoIs per image at P = 7, 128 mask RoIs at P = 14
    for name, n, p in (("box_head", 512, 7), ("mask_head", 128, 14)):
        boxes = torch.cat([random_boxes(gen, BATCH, n // 2, CANVAS, dev), cluster_boxes(gen, BATCH, n - n // 2, dev)], 1)
        g32 = torch.randn(BATCH, n, p, p, 256, generator=gen, device=dev)
        g16 = g32.to(torch.bfloat16)
        worst = max(worst, k3_against_plain(g32, boxes, shapes, scales, p, 2, name))
        k3_against_plain(g16, boxes, shapes, scales, p, 2, name)
        per_call[name] = (kernel_ms(lambda: Pm.multilevel_roi_align_backward_cuda(g16, boxes, shapes, scales, p, 2),
                                    K3_KERNELS),
                          cuda_ms(lambda: Pm.multilevel_roi_align_backward_plain(g16, boxes, shapes, scales, p, 2),
                                  iters=3, warmup=1))
        # the cotangent, boxes and levels read once, every cell of the gradient maps written once
        nbytes += g16.numel() * 2 + boxes.numel() * 5 + sum(math.prod(sh) for sh in shapes) * 2
        ops += g16.numel() * 4 * (4 * 2)  # 4 samples x 4 corners x (weight * g, add)
    stats["roi_align_backward"] = dict(
        name="roi_align_backward", route="cuda", source="mmt_psm_tpu_torch/csrc/roi_align.cu",
        replaces="mmt_psm_tpu/ops/roi_align_pallas.py:363", max_abs_err=worst,
        ms=sum(v[0] for v in per_call.values()), plain_ms=sum(v[1] for v in per_call.values()),
        **bound(nbytes, ops), library_ms=None,
    )
    print("K3 per call (kernel ms, plain ms): " + json.dumps(per_call), flush=True)


# ----------------------------------------------------------- flagship path
def flagship(dev, stats):
    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm

    model = build_model(device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.randn(BATCH, CANVAS, CANVAS, 3, generator=gen, device=dev) * 40.0 for _ in range(BATCHES)]
    sizes = torch.tensor([[CANVAS, CANVAS], [CANVAS, 900], [800, CANVAS], [700, 650]], dtype=torch.int32).to(dev)
    model(batches[0], sizes)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    # the forward must not wait on the card (what a CUDA graph capture needs):
    # any synchronising call inside it raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        model(batches[0], sizes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    N.suppress_cuda.launches = 0
    Pm.multilevel_roi_align_cuda.launches = 0
    t = time.perf_counter()
    outs = [model(x, sizes) for x in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"nms": N.suppress_cuda.launches, "roi_align": Pm.multilevel_roi_align_cuda.launches}
    # per forward: K1 for the RPN and for relation-NMS, K2 for the box and mask heads
    for k, v in launches.items():
        if v != 2 * BATCHES:
            raise AssertionError(f"kernel {k} launched {v} times in {BATCHES} forwards, expected {2 * BATCHES}")
        stats[k]["launches"] = v
    k_det = 2 * model.config.relation.first_n
    for d in outs:
        if d.boxes.shape != (BATCH, k_det, 4) or d.masks.shape != (BATCH, k_det, 28, 28):
            raise AssertionError(f"unexpected detection shapes {tuple(d.boxes.shape)} {tuple(d.masks.shape)}")
        for name in ("boxes", "scores", "masks"):
            if not torch.isfinite(getattr(d, name)).all():
                raise AssertionError(f"non-finite {name}")
        if not bool(d.valid.any()):
            raise AssertionError("no valid detection")
    print(f"flagship bf16: {BATCHES} batches of {BATCH} at {CANVAS}px, valid detections per image "
          f"{[int(v) for v in outs[-1].valid.sum(1)]}, launches {launches}", flush=True)
    return BATCHES * BATCH / wall


# the weights of the f32 flagship comparison. CIAM's softmax over unnormalised
# per-channel Gram energies is ill-conditioned at random weights: under
# flax's truncated lecun_normal, seed 0's weights give one instance whose
# mask probabilities move 5e-3 for the ~1e-6 relative float32 noise of K2
# against its plain version (7.3e-5 with CIAM skipped, the kernels
# deterministic); seed 2's give 210 detections and 5.0e-5 (an H100 80GB
# HBM3, scripts/flagship_f32_seeds.py)
F32_FLAGSHIP_SEED = 2


def flagship_f32_vs_plain(dev):
    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(device=dev, seed=F32_FLAGSHIP_SEED, opts=["TPU.COMPUTE_DTYPE", "float32"])
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, CANVAS, CANVAS, 3, generator=gen, device=dev) * 40.0
    sizes = torch.tensor([[CANVAS, CANVAS], [900, 1000]], dtype=torch.int32).to(dev)
    got = model(x, sizes)
    # the same forward with the wrappers' kernel calls swapped for the plain versions
    with mock.patch.object(N, "suppress_cuda", N.suppress_plain), \
            mock.patch.object(Pm, "multilevel_roi_align_cuda", Pm.multilevel_roi_align_plain):
        want = model(x, sizes)
    if not (torch.equal(got.valid, want.valid) and torch.equal(got.labels, want.labels)):
        raise AssertionError("f32 detections: valid/labels differ between kernels and plain versions")
    # the kernels differ from the plain versions only in float32 summation
    # order (~1e-6 relative in pooled features), which the untrained heads
    # amplify; the first run on an H100 measured 9e-5 on scores
    errs = {k: float((getattr(got, k) - getattr(want, k)).abs().max()) for k in ("boxes", "scores", "masks")}
    limits = {"boxes": 1e-2, "scores": 1e-3, "masks": 1e-3}
    for k, e in errs.items():
        if not e <= limits[k]:
            raise AssertionError(f"f32 detections: {k} differ by {e} > {limits[k]}")
    torch.backends.cudnn.allow_tf32 = True
    print(f"flagship f32 kernels vs plain: valid/labels identical, max abs err {errs} "
          f"(limits {limits}), {int(got.valid.sum())} valid", flush=True)


# ----------------------------------------------------------- serving path
# 8 synthetic slides of one 1024-px window each (two slides of 2048 would
# hold 128 x 2048^2 uint8 masks each while they are made); the cells' radii,
# a fraction of the slide, are halved from the test CLI's 512-px slides, so
# cells have the size of the CLI windows' cells
EVAL_SLIDES = dict(seed=7, num_slides=8, slide_size=CANVAS, win_size=CANVAS, overlap=0.0, is_train=False,
                   radius_range=(0.04, 0.09))
EVAL_MAX_GT = 64
RESULT_KEYS = {"AJI", "AJI_mean", "mAP", "AP50", "AP75", "AP85", "F1", "images_per_sec"}
# final_eval.json of the train CLI (the JAX CLI's, tools/train_mean_teacher.py:155-161)
FINAL_EVAL_KEYS = {"AJI", "AJI_mean", "mAP", "AP50", "images_per_sec"}


def own_instances_as_gt(model, ds, batch, canvas, max_gt):
    """The windows of ``ds`` with the model's own pasted instances as gt
    (at most ``max_gt`` an image, the categories taken in turn), every
    other one moved 2 px right: stats that random weights would leave at 0
    against the synthetic cells spread over (0, 1], so that comparing two
    scorings of them can fail."""
    import itertools

    import numpy as np

    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.engine.inference import DeviceStage
    from mmt_psm_tpu_torch.engine.paste import detections_to_instseg

    stage, items = DeviceStage(model), []
    for b in make_test_loader(ds, batch, canvas, max_gt=max_gt, min_size=canvas, max_size=canvas, raw_u8=True):
        boxes, scores, labels, valid, masks, _ = stage.fetch(stage.dispatch(b))
        if masks is None:  # a box-only model: each box filled, as the engine pastes it
            masks = np.ones(boxes.shape[:2] + (1, 1), np.float32)
        for i in range(b["n_real"]):
            h, w = b["image_size"][i].tolist()
            gt = []
            dt = detections_to_instseg(boxes[i], scores[i], labels[i], valid[i], masks[i].astype(np.float32),
                                       (h, w))
            for c, inst in sorted(dt.items()):
                for k, (bx, m) in enumerate(zip(inst.boxes, inst.masks)):
                    full = np.zeros((h, w), np.uint8)
                    full[bx[1] : bx[3] + 1, bx[0] : bx[2] + 1] = m
                    if k % 2:
                        full = np.pad(full, ((0, 0), (2, 0)))[:, :w]
                    if np.count_nonzero(full) >= 4:
                        gt.append((c, full))
            by_cat = [[g for g in gt if g[0] == c] for c in sorted({c for c, _ in gt})]
            gt = [g for turn in itertools.zip_longest(*by_cat) for g in turn if g is not None][:max_gt]
            yx = [np.nonzero(f) for _, f in gt]
            items.append({"image": b["image"][i],
                          "boxes": np.array([[x.min(), y.min(), x.max(), y.max()] for y, x in yx], np.float32)
                          .reshape(-1, 4),
                          "labels": np.array([c for c, _ in gt], np.int32),
                          "masks": np.array([f for _, f in gt], np.uint8).reshape(-1, h, w)})
    return items


def scored(result, what):
    """Raise unless ``result`` has an AJI and a mAP above 0."""
    if not (max(result["AJI"].values(), default=0) > 0 and result["mAP"]["all"] > 0):
        raise AssertionError(f"{what}: AJI {result['AJI']}, mAP {result['mAP']}: expected both above 0")


def first_image_host_eval(batch, outs):
    """The first image of a batch pasted and scored: (per-class instance
    masks, Papeval's rows, its summary)."""
    import numpy as np

    from mmt_psm_tpu_torch.engine.paste import detections_to_instseg, gt_to_instseg
    from mmt_psm_tpu_torch.evaluation.pap_eval import PapEvaluator

    boxes, scores, labels, valid, masks, _ = outs
    dt = detections_to_instseg(boxes[0], scores[0], labels[0], valid[0], masks[0].astype(np.float32),
                               tuple(batch["image_size"][0].tolist()))
    gt = gt_to_instseg(batch["boxes"][0], batch["labels"][0], batch["gt_valid"][0], batch["masks"][0])
    ev = PapEvaluator()
    ev.add_image(dt, gt)
    inst = {c: (v.boxes.tolist(), [m.tobytes() for m in v.masks]) for c, v in dt.items()}
    rows = [(r.category_id, r.n_gt, r.n_dt, r.aji, r.f1, r.fnr, r.fdr, r.map_dtm.tobytes(), r.dsc.tobytes(),
             r.tpr.tobytes()) for r in ev.results]
    return inst, rows, ev.summarize()


def eval_path(dev, stats):
    import os
    import tempfile

    import numpy as np

    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.data.loader import make_test_loader, usable_cpus
    from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
    from mmt_psm_tpu_torch.engine import inference as I
    from mmt_psm_tpu_torch.evaluation import _native
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm
    from mmt_psm_tpu_torch.tools import test_net
    from mmt_psm_tpu_torch.utils.checkpoint import Checkpointer

    model = build_model(device=dev, seed=0)
    t = time.perf_counter()
    ds = synthetic_slide_dataset(**EVAL_SLIDES)
    data_s = time.perf_counter() - t
    if len(ds) != 8:
        raise AssertionError(f"{len(ds)} windows, expected 8")
    t = time.perf_counter()
    items = own_instances_as_gt(model, ds, BATCH, CANVAS, EVAL_MAX_GT)
    gt_s = time.perf_counter() - t
    n_gt = [len(it["labels"]) for it in items]
    if min(n_gt) == 0:
        raise AssertionError(f"gt instances an image: {n_gt}")
    gt_by_cat = {int(c): int(n) for c, n in zip(*np.unique(np.concatenate([it["labels"] for it in items]),
                                                             return_counts=True))}
    batches = lambda: make_test_loader(items, BATCH, CANVAS, max_gt=EVAL_MAX_GT, min_size=CANVAS,  # noqa: E731
                                       max_size=CANVAS, raw_u8=True)
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save("model_0000001", {"model": model.state_dict()})
        # the measured run: scored in this process, which is what 8 windows
        # are fastest with (a pool's start is reported beside it)
        N.suppress_cuda.launches = 0
        Pm.multilevel_roi_align_cuda.launches = 0
        result, timing = I.run_inference(model, batches(), eval_workers=0)
        launches = {"nms": N.suppress_cuda.launches, "roi_align": Pm.multilevel_roi_align_cuda.launches}
        n_batches = -(-len(items) // BATCH)
        # per batch: K1 for the RPN and relation-NMS, K2 for the box and mask heads
        for k, v in launches.items():
            if v != 2 * n_batches:
                raise AssertionError(f"kernel {k} launched {v} times in {n_batches} eval batches, "
                                     f"expected {2 * n_batches}")
            stats[k]["launches_eval"] = v
        if timing["images"] != len(items):
            raise AssertionError(f"{timing['images']} images evaluated, expected {len(items)}")
        bad = {m: v for m, per in result.items() for v in per.values() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite stats: {bad}")
        scored(result, "serial run")
        # the same run scored by a pool of spawned workers: rows in image order
        workers = max(usable_cpus() - 1, 0)
        pooled, pool_timing = I.run_inference(model, batches(), eval_workers=-1)
        if pool_timing["pool_start_seconds"] is None:
            raise AssertionError(f"no pool of eval workers on {usable_cpus()} cores")
        if pooled != result:
            raise AssertionError("stats of the pool of eval workers differ from the serial run's")

        # the C++ library against its plain numpy versions on the first image
        batch = next(batches())
        stage = I.DeviceStage(model)
        outs = stage.fetch(stage.dispatch(batch))
        native = first_image_host_eval(batch, outs)
        build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mmt_psm_tpu_torch", "_build")
        if os.path.dirname(_native.library_path() or "") != build:
            raise AssertionError(f"the C++ library was loaded from {_native.library_path()}, not from {build}")
        scored(native[2], "first image")
        with contextlib.ExitStack() as swap:
            for entry in _native.ENTRY_POINTS:
                swap.enter_context(mock.patch.object(_native, entry, getattr(_native, entry + "_plain")))
            plain = first_image_host_eval(batch, outs)
        for what, a, b in zip(("instance masks", "Papeval rows", "Papeval stats"), native, plain):
            if a != b:
                raise AssertionError(f"first image: {what} of the C++ library differ from the plain versions")
        n_inst = sum(len(v[1]) for v in native[0].values())

        t = time.perf_counter()
        out_dir = os.path.join(tmp, "out")
        test_net.main(["--config-file", FLAGSHIP_CONFIG, "--ckpt-dir", tmp, "--synthetic", "--output-dir", out_dir,
                       "TEST.IMS_PER_BATCH", str(BATCH)])
        cli_s = time.perf_counter() - t
        with open(os.path.join(out_dir, "result.json")) as f:
            rows = json.load(f)
        if list(rows) != ["model_0000001"] or set(rows["model_0000001"]) != RESULT_KEYS:
            raise AssertionError(f"unexpected result.json: {rows}")
        if not os.path.exists(os.path.join(out_dir, "best_result.json")):
            raise AssertionError("no best_result.json")
    print(f"eval bf16: {timing['images']} windows of {CANVAS}px (data made in {data_s:.3f} s on the host, "
          f"{EVAL_SLIDES}; the model's own instances as gt, {n_gt} an image, {gt_by_cat} by category, in {gt_s:.3f} s), batch {BATCH}, "
          f"launches {launches}; first image {n_inst} pasted instances, paste and stats of the C++ library "
          f"identical to the plain versions; stats {json.dumps(result)}; "
          f"CLI --synthetic in {cli_s:.3f} s: {json.dumps(rows)}", flush=True)
    print(f"eval pool ({workers} spawned workers, stats identical to the serial run's): "
          f"{pool_timing['images_per_sec']} evaluated patches/s, the pool's start "
          f"{pool_timing['pool_start_seconds']} s, stage_seconds {json.dumps(pool_timing['stage_seconds'])} of "
          f"{pool_timing['seconds']} s", flush=True)
    # an eval worker's own start; the pool's start above also holds each
    # worker's import of the main module (this script, and so torch)
    starts = {}
    for what, code in (("python", "pass"),
                       ("eval worker", "import mmt_psm_tpu_torch.engine._eval_worker as w; w.ping()")):
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        starts[what] = time.perf_counter() - t
    print(f"process start on the host, one at a time (s): {json.dumps(starts)}", flush=True)
    return timing, ds


# ------------------------------------------------------------- train path
def frozen_names(model):
    """state_dict names the step must leave bit-unchanged: the stem, layer1
    and every FrozenBN tensor."""
    from mmt_psm_tpu_torch.models.layers import FrozenBatchNorm2d

    bn = {n for n, m in model.named_modules() if isinstance(m, FrozenBatchNorm2d)}
    return [n for n in model.state_dict() if n.rsplit(".", 1)[0] in bn
            or n.startswith(("backbone.body.stem.", "backbone.body.layer1."))]


def train_path(dev, stats):
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm
    from mmt_psm_tpu_torch.train import build_trainer

    trainer = build_trainer(device=dev, seed=0)
    model = trainer.model
    max_gt = int(trainer.cfg.TPU.MAX_GT)
    batches = [batch_to_torch(generate_batch(s, BATCH, image_size=CANVAS, max_instances=max_gt), dev)
               for s in range(3)]
    frozen = {n: model.state_dict()[n].clone() for n in frozen_names(model)}
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    for i in range(TRAIN_WARMUP):
        trainer.step(batches[i % 3])
    torch.cuda.synchronize()
    # forward, backward and SGD step must not wait on the card: any
    # synchronising call inside the step raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.step(batches[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    counters = {"nms": N.suppress_cuda, "roi_align": Pm.multilevel_roi_align_cuda,
                "roi_align_backward": Pm.multilevel_roi_align_backward_cuda}
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    outs = [trainer.step(batches[i % 3]) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    # per step: K1 for the RPN; K2 and K3 for the box and mask heads
    expected = {"nms": TRAIN_STEPS, "roi_align": 2 * TRAIN_STEPS, "roi_align_backward": 2 * TRAIN_STEPS}
    if launches != expected:
        raise AssertionError(f"kernel launches in {TRAIN_STEPS} train steps: {launches}, expected {expected}")
    stats["nms"]["launches_train"] = launches["nms"]
    stats["roi_align"]["launches_train"] = launches["roi_align"]
    stats["roi_align_backward"]["launches"] = launches["roi_align_backward"]

    losses = {k: [float(o[k]) for o in outs] for k in outs[0]}
    for k, v in losses.items():
        if not all(math.isfinite(x) for x in v):
            raise AssertionError(f"non-finite {k}: {v}")
    sd = model.state_dict()
    changed = [n for n in frozen if not torch.equal(sd[n], frozen[n])]
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    params = dict(model.named_parameters())
    # the MGD hint adaptor's biases get no gradient in a supervised step and no decay
    still = [n for n, p0 in trainable.items() if torch.equal(params[n].detach(), p0)
             and not (n.startswith("hint_adaptor.") and n.endswith(".bias"))]
    # a weight decays even where its gradient is 0; a bias moves where its gradient is not
    if [n for n in still if not n.endswith(".bias")] or len(still) > len(trainable) // 20:
        raise AssertionError(f"trainable tensors that did not move: {still}")
    print(f"train bf16: {TRAIN_STEPS} steps of {BATCH} at {CANVAS}px after {TRAIN_WARMUP + 1} warm-up, "
          f"losses of the last step {json.dumps({k: v[-1] for k, v in losses.items()})}, "
          f"{len(trainable) - len(still)}/{len(trainable)} trainable tensors moved, {len(frozen)} frozen "
          f"bit-unchanged, launches {launches}", flush=True)
    return TRAIN_STEPS * BATCH / wall


def norm_diffs(got, want, rtol, what):
    """Hold each tensor by ||g - w|| <= rtol ||w|| + 1e-6 (the 1e-6 for
    gradients that are 0 but for rounding: WK's bias, whose shift a softmax
    ignores); returns the three worst |diff|/|w| and max|diff|/max|w|."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: the kernels and the plain versions give other tensors")
    diff = {n: float(torch.linalg.vector_norm(got[n] - w)) for n, w in want.items()}
    norm = {n: float(torch.linalg.vector_norm(w)) for n, w in want.items()}
    over = {n: (diff[n], norm[n]) for n in diff if not diff[n] <= rtol * norm[n] + 1e-6}
    if over:
        raise AssertionError(f"{what} differ beyond {rtol} of their norm: {over}")
    l2 = {n: diff[n] / max(norm[n], 1e-30) for n in diff}
    peak = {n: float((got[n] - w).abs().max() / w.abs().max().clamp(min=1e-30)) for n, w in want.items()}
    worst = lambda d: sorted(((v, n) for n, v in d.items()), reverse=True)[:3]  # noqa: E731
    return f"{len(l2)} {what} within {rtol} of their norm + 1e-6; worst |diff|/|w| {worst(l2)}, " \
           f"worst max|diff|/max|w| {worst(peak)}"


def train_f32_vs_plain(dev):
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.train import build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = batch_to_torch(generate_batch(7, 2, image_size=CANVAS, max_instances=64), dev)

    def step(swap):
        trainer = build_trainer(device=dev, seed=0, opts=["TPU.COMPUTE_DTYPE", "float32"])
        with torch.no_grad():  # keep the relation head's geometric gate off its pole (see GRAD_RTOL)
            trainer.model.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
        plain = kernel_wrappers()
        with contextlib.ExitStack() as stack:
            for name in swap:  # the wrappers' kernel calls swapped for the plain versions
                stack.enter_context(mock.patch.object(*plain[name]))
            losses = trainer.step(batch)
        grads = {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None}
        return {k: float(v) for k, v in losses.items()}, grads

    got_l, got_g = step(())
    lines = []
    for swap, rtol in ((("nms", "roi_align", "roi_align_backward"), GRAD_RTOL), (("roi_align_backward",), K3_GRAD_RTOL)):
        want_l, want_g = step(swap)
        bad = {k: (got_l[k], want_l[k]) for k in want_l if not abs(got_l[k] - want_l[k]) <= LOSS_RTOL * abs(want_l[k])}
        if bad:
            raise AssertionError(f"f32 train step, {swap} plain: losses differ beyond {LOSS_RTOL} relative: {bad}")
        lines.append(f"{'+'.join(swap)} plain: losses within {LOSS_RTOL} relative (max "
                     f"{max(abs(got_l[k] - want_l[k]) / abs(want_l[k]) for k in want_l):.3g}), "
                     + norm_diffs(got_g, want_g, rtol, f"gradients ({'+'.join(swap)} plain)"))
    torch.backends.cudnn.allow_tf32 = True
    print("train f32 kernels vs " + "; ".join(lines), flush=True)


# ------------------------------------------------------ mean-teacher path
MT_WARMUP, MT_STEPS = 2, 5
# per MT step: K1 for the supervised RPN, the teacher's RPN, its relation-NMS
# and its train-mode proposals against the pseudo gt; K2 for the supervised
# box and mask heads, the teacher's box and mask heads, the teacher's PSM box
# head over the 2K stacked views (16 images x 512 RoIs) and the student's PSM
# box head; K3 for the supervised box and mask heads and the student's PSM box head
MT_LAUNCHES = {"nms": 4, "roi_align": 6, "roi_align_backward": 3}


def kernel_wrappers():
    """stats key -> (module, name of the wrapper's kernel call, the kernel's
    plain version)."""
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm

    return {"nms": (N, "suppress_cuda", N.suppress_plain),
            "roi_align": (Pm, "multilevel_roi_align_cuda", Pm.multilevel_roi_align_plain),
            "roi_align_backward": (Pm, "multilevel_roi_align_backward_cuda", Pm.multilevel_roi_align_backward_plain)}


@contextlib.contextmanager
def recording(calls):
    """Append (stats key, arguments) of every kernel call the wrappers make;
    the kernels still launch."""
    with contextlib.ExitStack() as stack:
        for key, (mod, attr, _) in kernel_wrappers().items():
            def rec(*a, _fn=getattr(mod, attr), _key=key):
                calls.append((_key, a))
                return _fn(*a)
            # a wrapper counts its launches on the name it is bound to: here the recorder
            rec.launches = 0
            stack.enter_context(mock.patch.object(mod, attr, rec))
        yield


@torch.no_grad()
def held_against_plain(key, a, scaled=False):
    """One recorded kernel call launched again and held against its plain
    version on the same inputs (K1's flags equal, K2 ATOL + rtol |want|, K3
    as ``k3_against_plain``); raises where they differ, else returns (the
    call's shape, its largest error). ``scaled``: the f32 bounds of K2 and
    K3 grow with the largest |value| past 1."""
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm

    if key == "nms":
        bs, vs, th = a
        shape = f"{bs.shape[0]} x {bs.shape[1]}"
        bad = int((N.suppress_cuda(bs, vs, th) != N.suppress_plain(bs, vs, th)).sum())
        if bad:
            raise AssertionError(f"K1 recorded call {shape}: {bad} flags differ from the plain version")
        return shape, 0.0
    if key == "roi_align":
        feats, boxes, scales, p, g = a
        shape = f"{boxes.shape[0]} x {boxes.shape[1]} P{p}"
        want = Pm.multilevel_roi_align_plain(*a).float()
        e = (Pm.multilevel_roi_align_cuda(*a).float() - want).abs()
        rtol = BF16_RTOL if feats[0].dtype == torch.bfloat16 else 0.0
        err = float(e.max())
        # ``scaled``: ATOL of the largest |value| where that passes 1 (PRCNN's
        # image-scale f32 maps reach ~1e2, where 1e-5 is a few ulps)
        atol = ATOL * max(1.0, float(want.abs().max())) if scaled else ATOL
        if not float((e - atol - rtol * want.abs()).max()) <= 0:
            raise AssertionError(f"K2 recorded call {shape} {feats[0].dtype}: max err {err}")
        return shape, err
    grad, boxes, shapes, scales, p, g = a
    shape = f"{boxes.shape[0]} x {boxes.shape[1]} P{p}"
    return shape, k3_against_plain(grad, boxes, shapes, scales, p, g, f"recorded call {shape}", scaled)


@torch.no_grad()
def time_calls(calls, scaled=False):
    """Per kernel: each recorded call held against its plain version on the
    same inputs (the tolerances of the phases above: K1's flags equal, K2
    ATOL + rtol |want|, K3 as ``k3_against_plain``), then the device ms of
    the recorded calls and CUDA-event ms of their plain versions, summed,
    the worst error, and the bound of them all (the same byte and operation
    counts as the phases above). ``scaled``: the f32 bounds of K2 and K3
    grow with the largest |value| past 1."""
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm

    wrappers = kernel_wrappers()
    out, per_call = {}, []
    for key, a in calls:
        shape, err = held_against_plain(key, a, scaled)
        if key == "nms":
            bs, vs, th = a
            n = bs.shape[1]
            kept = (~N.suppress_cuda(bs, vs, th) & vs).float()
            ms = kernel_ms(lambda: N.suppress_cuda(*a), K1_KERNELS)
            ops = 14.0 * float((kept * (n - 1 - torch.arange(n, device=bs.device))).sum())
            nbytes = bs.numel() * 4 + 2 * vs.numel() + th.numel() * 4
        elif key == "roi_align":
            feats, boxes, scales, p, g = a
            ms = kernel_ms(lambda: Pm.multilevel_roi_align_cuda(*a), K2_KERNELS)
            c, es = feats[0].shape[-1], feats[0].element_size()
            out_elems = boxes.shape[0] * boxes.shape[1] * p * p * c
            nbytes = sampled_cells(feats, boxes, scales, p, g) * c * es + boxes.numel() * 5 + out_elems * es
            ops = out_elems * g * g * (4 * 2 + 2)
        else:
            grad, boxes, shapes, scales, p, g = a
            ms = kernel_ms(lambda: Pm.multilevel_roi_align_backward_cuda(*a), K3_KERNELS)
            es = grad.element_size()
            nbytes = grad.numel() * es + boxes.numel() * 5 + sum(math.prod(sh) for sh in shapes) * es
            ops = grad.numel() * g * g * (4 * 2)
        plain_ms = cuda_ms(lambda: wrappers[key][2](*a), iters=3, warmup=1)
        acc = out.setdefault(key, [0.0, 0.0, 0, 0.0, 0.0])
        acc[0], acc[1], acc[2], acc[3] = acc[0] + ms, acc[1] + plain_ms, acc[2] + nbytes, acc[3] + ops
        acc[4] = max(acc[4], err)
        per_call.append((key, shape, round(ms, 4), round(plain_ms, 3), err, round(bound(nbytes, ops)["bound_ms"], 5)))
    return {k: (v[0], v[1], bound(v[2], v[3]), v[4]) for k, v in out.items()}, per_call


def mt_path(dev, stats):
    from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                  unlabeled_to_torch)
    from mmt_psm_tpu_torch.train import build_mt_trainer

    trainer = build_mt_trainer(device=dev, seed=0)
    model, teacher, mt, c = trainer.model, trainer.teacher, trainer.mt, trainer.model.config
    width = (c.image_size, mt.aug_k, mt.aug_s, c.box_head_dropout, c.box_batch_per_image, c.with_hint_adaptor)
    if width != (CANVAS, 2, 1, 0.5, 512, True):
        raise AssertionError(f"not the flagship's width: {width}")
    max_gt = int(trainer.cfg.TPU.MAX_GT)
    labeled = [batch_to_torch(generate_batch(s, BATCH, image_size=CANVAS, max_instances=max_gt), dev) for s in range(2)]
    unlabeled = [unlabeled_to_torch(generate_unlabeled_batch(10 + s, BATCH, image_size=CANVAS, aug_k=mt.aug_k,
                                                             aug_s=mt.aug_s, max_instances=max_gt), dev)
                 for s in range(2)]
    frozen = {n: model.state_dict()[n].clone() for n in frozen_names(model)}
    adaptor = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("hint_adaptor.")}
    teacher0 = {k: v.clone() for k, v in teacher.state_dict().items()}
    trainer.iteration = mt.start_mt + 1
    calls = []
    for i in range(MT_WARMUP):
        # the last warm-up step's kernel calls are the ones timed below
        with recording(calls) if i == MT_WARMUP - 1 else contextlib.nullcontext():
            trainer.step(labeled[i % 2], unlabeled[i % 2])
    torch.cuda.synchronize()
    found = {k: sum(key == k for key, _ in calls) for k in MT_LAUNCHES}
    if found != MT_LAUNCHES:
        raise AssertionError(f"kernel calls in one MT step: {found}, expected {MT_LAUNCHES}")
    timed, per_call = time_calls(calls)
    del calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.step(labeled[0], unlabeled[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    counters = {k: getattr(mod, attr) for k, (mod, attr, _) in kernel_wrappers().items()}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    outs = [trainer.step(labeled[i % 2], unlabeled[i % 2]) for i in range(MT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {k: fn.launches for k, fn in counters.items()}
    expected = {k: v * MT_STEPS for k, v in MT_LAUNCHES.items()}
    if launches != expected:
        raise AssertionError(f"kernel launches in {MT_STEPS} MT steps: {launches}, expected {expected}")
    for k, (ms, plain_ms, b, err) in timed.items():
        stats[k].update(ms_mt=ms, plain_ms_mt=plain_ms, bound_ms_mt=b["bound_ms"], bound_by_mt=b["bound_by"],
                        launches_mt=launches[k], max_abs_err_mt=err)

    losses = {k: [float(o[k]) for o in outs] for k in outs[0]}
    for k in ("mt_classifier", "mt_fg_loss", "loss_total") + tuple(losses):
        if k not in losses or not all(math.isfinite(x) for x in losses[k]):
            raise AssertionError(f"missing or non-finite {k}: {losses.get(k)}")
    if not all(w > 0 for w in losses["mt_weight"]):
        raise AssertionError(f"mt_weight {losses['mt_weight']}")
    sd, t_sd = model.state_dict(), teacher.state_dict()
    changed = [n for n in frozen if not torch.equal(sd[n], frozen[n])]
    if changed:
        raise AssertionError(f"frozen tensors of the student changed: {changed[:5]}")
    params = dict(model.named_parameters())
    t_still = [n for n in params if params[n].requires_grad and torch.equal(t_sd[n], teacher0[n])]
    if t_still:
        raise AssertionError(f"teacher tensors the EMA did not move: {t_still[:5]}")
    if all(torch.equal(t_sd[k], sd[k]) for k in t_sd):
        raise AssertionError("the teacher equals the student")
    a_still = [n for n, p0 in adaptor.items() if torch.equal(params[n].detach(), p0)]
    if a_still:
        raise AssertionError(f"hint adaptor tensors that did not move: {a_still}")
    print(f"mt bf16: {MT_STEPS} MT steps of {BATCH} labeled + {BATCH} unlabeled ({mt.aug_k} teacher views and "
          f"their flips, {mt.aug_s} student view) at {CANVAS}px from iteration {mt.start_mt + 1}, after "
          f"{MT_WARMUP + 1} warm-up; losses of the last step {json.dumps({k: v[-1] for k, v in losses.items()})}; "
          f"launches {launches}; teacher moved and differs from the student, {len(frozen)} frozen bit-unchanged, "
          f"{len(adaptor)} hint adaptor tensors moved; peak memory {peak_gib:.3f} GiB", flush=True)
    print("MT step's kernel calls, each held against its plain version (kernel, shape, kernel ms, plain ms, "
          "max abs err, bound ms): " + json.dumps(per_call), flush=True)
    return MT_STEPS * BATCH / wall, peak_gib


def mt_f32_vs_plain(dev):
    from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                  unlabeled_to_torch)
    from mmt_psm_tpu_torch.train import build_mt_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lab = batch_to_torch(generate_batch(7, 2, image_size=CANVAS, max_instances=64), dev)
    unl = unlabeled_to_torch(generate_unlabeled_batch(17, 2, image_size=CANVAS, max_instances=64), dev)
    plain = kernel_wrappers()

    def step(swap):
        trainer = build_mt_trainer(device=dev, seed=0, opts=["TPU.COMPUTE_DTYPE", "float32"])
        with torch.no_grad():  # the relation head's geometric gate off its pole (see GRAD_RTOL)
            for m in (trainer.model, trainer.teacher):
                m.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
        # the ramp's plateau, where the MT losses count LAMBDA times their
        # weights: just past START_MT they count ~0.035 of that, and the
        # supervised part would swamp the MT branch's gradients (the student
        # PSM's K3 call among them)
        trainer.iteration = trainer.mt.start_mt + trainer.mt.rampup_step
        t0 = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
        with contextlib.ExitStack() as stack:
            for name in swap:  # the wrappers' kernel calls swapped for the plain versions
                stack.enter_context(mock.patch.object(*plain[name]))
            losses = trainer.step(lab, unl)
        if float(losses["mt_weight"]) != trainer.mt.lambda_:
            raise AssertionError(f"f32 MT step: mt_weight {float(losses['mt_weight'])}, not LAMBDA")
        grads = {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None}
        # the EMA's move: (1 - alpha) times the student's
        moved = {k: v - t0[k] for k, v in trainer.teacher.state_dict().items()}
        return {k: float(v) for k, v in losses.items()}, grads, moved

    got_l, got_g, got_t = step(())
    if not {"mt_classifier", "mt_fg_loss"} <= set(got_l):
        raise AssertionError(f"f32 MT step: no MT losses in {sorted(got_l)}")
    lines = []
    for swap, rtol in ((("nms", "roi_align", "roi_align_backward"), GRAD_RTOL), (("roi_align_backward",), K3_GRAD_RTOL)):
        want_l, want_g, want_t = step(swap)
        bad = {k: (got_l[k], want_l[k]) for k in want_l if not abs(got_l[k] - want_l[k]) <= LOSS_RTOL * abs(want_l[k])}
        if bad:
            raise AssertionError(f"f32 MT step, {swap} plain: losses differ beyond {LOSS_RTOL} relative: {bad}")
        lines.append(f"{'+'.join(swap)} plain: losses within {LOSS_RTOL} relative (max "
                     f"{max(abs(got_l[k] - want_l[k]) / abs(want_l[k]) for k in want_l):.3g}), "
                     + norm_diffs(got_g, want_g, rtol, f"MT gradients ({'+'.join(swap)} plain)") + "; "
                     + norm_diffs(got_t, want_t, rtol, f"teacher EMA moves ({'+'.join(swap)} plain)"))
    torch.backends.cudnn.allow_tf32 = True
    print("mt f32 kernels vs " + "; ".join(lines), flush=True)


# ---------------------------------------------------- training entry point
# the first CLI run: START_MT 2, MAX_ITER 6, so iterations 0-2 take the
# supervised step (K1 1, K2 2, K3 2 launches each) and 3-5 the MT step
# (MT_LAUNCHES each); a save every 2 iterations, the teacher's past START_MT
CLI_OPTS = ["MT.START_MT", "2", "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_WORKERS", "0"]
CLI_LAUNCHES = {"nms": 3 + 3 * 4, "roi_align": 3 * 2 + 3 * 6, "roi_align_backward": 3 * 2 + 3 * 3}
CLI_NAMES = ["model_0000002", "model_0000004", "model_final", "t_model_0000004", "t_model_final"]
LOADER_BATCHES = 3


class Waited:
    """An iterator that sums the seconds its consumer waits in ``next``."""

    def __init__(self, it):
        self.it, self.seconds = it, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.seconds += time.perf_counter() - t

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


def train_cli_path(dev, stats, sup_images_per_s, mt_images_per_s, eval_ds):
    import os
    import tempfile

    from mmt_psm_tpu_torch.data.loader import make_source_loader, make_unlabeled_loader
    from mmt_psm_tpu_torch.data.pap import PapDataset, PapUnlabeledDataset
    from mmt_psm_tpu_torch.engine import trainer as T
    from mmt_psm_tpu_torch.tools import train_mean_teacher

    counters = {k: getattr(mod, attr) for k, (mod, attr, _) in kernel_wrappers().items()}
    runs, waits, saves = [], [], []
    real_train, real_save, real_prefetch = T.MTTrainer.train, T.MTTrainer.save, T.prefetch

    def train(self, start_iter=0):
        # the loop's launches: counts set to 0 just before it, read just after
        for fn in counters.values():
            fn.launches = 0
        n_saves = len(saves)
        t = time.perf_counter()
        out = real_train(self, start_iter)
        torch.cuda.synchronize()
        runs.append(dict(loop=self, start=start_iter, seconds=time.perf_counter() - t, saves=saves[n_saves:],
                         launches={k: fn.launches for k, fn in counters.items()}))
        return out

    def save(self, iteration, final=False):
        t = time.perf_counter()
        real_save(self, iteration, final)
        saves.append(("model_final" if final else f"model_{iteration:07d}", time.perf_counter() - t))

    def prefetch(batches, depth):  # the loop's waits on each loader: source first
        waits.append(Waited(real_prefetch(batches, depth)))
        return waits[-1]

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(T.MTTrainer, "train", train), mock.patch.object(T.MTTrainer, "save", save), \
            mock.patch.object(T, "prefetch", prefetch):
        out = os.path.join(tmp, "run")
        flags = ["--synthetic", "--output-dir", out]
        first = train_mean_teacher.main(flags + CLI_OPTS + ["SOLVER.MAX_ITER", "6"])
        loop, width = first["trainer"], first["trainer"].steps.model.config
        if (width.image_size, width.compute_dtype, int(loop.cfg.SOLVER.IMS_PER_BATCH), loop.mt.aug_k,
                loop.mt.aug_s) != (CANVAS, "bfloat16", BATCH, 2, 1):
            raise AssertionError(f"not the flagship's width: {width.image_size} {width.compute_dtype}")
        run = runs[0]
        if run["launches"] != CLI_LAUNCHES:
            raise AssertionError(f"kernel launches in the CLI's loop: {run['launches']}, expected {CLI_LAUNCHES}")
        for k, v in run["launches"].items():
            stats[k]["launches_cli"] = v
        names = sorted(f[: -len(".pth")] for f in os.listdir(out) if f.endswith(".pth"))
        with open(os.path.join(out, "last_checkpoint")) as f:
            tag = f.read().strip()
        if names != CLI_NAMES or tag != "model_final":
            raise AssertionError(f"checkpoints {names}, tag {tag}: expected {CLI_NAMES}, model_final")
        losses = {k: list(m.deque) for k, m in loop.meters.meters.items() if k != "time"}
        if len(losses["loss_total"]) != 6 or len(losses["mt_weight"]) != 3 or \
                not all(math.isfinite(x) for v in losses.values() for x in v):
            raise AssertionError(f"logged losses not finite: {losses}")
        with open(os.path.join(out, "log.txt")) as f:
            logged = [int(m) for m in re.findall(r"iter: (\d+) ", f.read())]
        with open(os.path.join(out, "final_eval.json")) as f:
            summary = json.load(f)
        if logged != [0, 5] or set(summary) != FINAL_EVAL_KEYS:
            raise AssertionError(f"logged iterations {logged}, final_eval.json keys {sorted(summary)}")
        sizes = {n: os.path.getsize(os.path.join(out, f"{n}.pth")) for n in names}
        source_wait, unlabeled_wait = (w.seconds for w in waits[:2])
        step_s = run["seconds"] - sum(s for _, s in run["saves"])
        # warm: iterations 1-5 (2 supervised, 3 MT), without iteration 0's wait
        # for the first batch; the saves after iterations 2 and 4 fall into the
        # times of iterations 3 and 5
        times = list(loop.meters.meters["time"].deque)
        warm_s = sum(times[1:]) - sum(s for n, s in run["saves"] if n != "model_final")
        warm = BATCH * 5 / warm_s
        # the same 2 supervised + 3 MT steps at the rates of train bf16 and mt bf16
        steps_alone = BATCH * 5 / (2 * BATCH / sup_images_per_s + 3 * BATCH / mt_images_per_s)

        second = train_mean_teacher.main(flags + ["--skip-test"] + CLI_OPTS + ["SOLVER.MAX_ITER", "8"])
        if second["start_iter"] != 6 or runs[1]["start"] != 6:
            raise AssertionError(f"the second run started at iteration {second['start_iter']}, not 6")
        resumed = {k: list(m.deque) for k, m in second["trainer"].meters.meters.items() if k != "time"}
        if len(resumed["mt_weight"]) != 2 or not all(math.isfinite(x) for v in resumed.values() for x in v):
            raise AssertionError(f"losses of the resumed run: {resumed}")
    print(f"train CLI bf16: --synthetic at {CANVAS}px, batch {BATCH}, {loop.mt.aug_k} + {loop.mt.aug_s} views, "
          f"START_MT 2, 6 iterations (3 supervised, 3 MT) in {run['seconds']:.3f} s, launches {run['launches']}; "
          f"checkpoints {names}, tag {tag}; logged iterations {logged}; final_eval {json.dumps(summary)}; "
          f"resumed at iteration {second['start_iter']} to 8 in {runs[1]['seconds']:.3f} s", flush=True)
    print(f"train CLI loop: {warm:.3f} labeled images/s over iterations 1-5 (2 supervised, 3 MT) without the "
          f"saves ({warm_s:.3f} s), against {steps_alone:.3f} for the same steps alone at the rates of train bf16 "
          f"({sup_images_per_s:.3f}) and mt bf16 ({mt_images_per_s:.3f}); all 6 iterations {BATCH * 6 / step_s:.3f} "
          f"({step_s:.3f} s; per iteration {json.dumps([round(x, 4) for x in times])} s); the loop waited "
          f"{source_wait:.3f} s on the source loader and {unlabeled_wait:.3f} s on the unlabeled one", flush=True)
    print(f"train CLI saves (s): {json.dumps([(n, round(s, 3)) for n, s in run['saves'] + runs[1]['saves']])}; "
          f"checkpoint bytes {json.dumps(sizes)}", flush=True)

    # the loaders alone at the real Pap window: 1000-px windows of the serving
    # phase's synthetic slides, resized to MIN_SIZE_TRAIN 800 on the 1024 canvas
    windows = PapDataset(eval_ds.slides, eval_ds.annotations, win_size=1000, overlap=0.0, is_train=True)
    patches = PapUnlabeledDataset([s[:1000, :1000] for s in eval_ds.slides])
    rates, first = {}, {}
    for what, it in (("source", make_source_loader(windows, BATCH, CANVAS, max_gt=EVAL_MAX_GT, min_size=800,
                                                   max_size=CANVAS)),
                     ("unlabeled", make_unlabeled_loader(patches, BATCH, CANVAS, 2, 1, min_size=800, max_size=CANVAS))):
        t = time.perf_counter()
        batches = [next(it) for _ in range(LOADER_BATCHES)]
        rates[what] = LOADER_BATCHES / (time.perf_counter() - t)
        if not all((b["image_size"] == 800).all() for b in batches):
            raise AssertionError(f"{what} loader: image sizes {[b['image_size'].tolist() for b in batches]}")
        first[what] = batches[0]
    gt = first["source"]["gt_valid"].sum(1).tolist()
    print(f"training loaders, one thread each, {LOADER_BATCHES} batches of {BATCH} 1000-px windows at MIN_SIZE_TRAIN "
          f"800: source {rates['source']:.3f} batches/s, unlabeled (2 + 1 views) {rates['unlabeled']:.3f} batches/s, "
          f"against {mt_images_per_s / BATCH:.3f} MT steps/s ({len(windows)} windows; gt an image of the first "
          f"batch {gt})",
          flush=True)
    return warm, steps_alone, rates


# ------------------------------------------------------ the model variants
# every graph of ModelConfig.from_cfg beside the flagship
# (mmt_psm_tpu_torch/models/variants.py); per variant the kernel launches of
# one forward and of one supervised step: K1 for the RPN and the greedy
# post-processor (or relation-NMS), K2 for the box and mask heads (PRCNN:
# the box head and its four image scales), K3 for each K2 call of training
def _launches(nms, roi_align, roi_align_backward=0):
    return {"nms": nms, "roi_align": roi_align, "roi_align_backward": roi_align_backward}


VARIANT_LAUNCHES = {
    "mask_rcnn_fpn": (_launches(2, 2), _launches(1, 2, 2)),
    "set_nms": (_launches(1, 2), _launches(1, 2, 2)),
    "mask_rel_cam": (_launches(2, 2), _launches(1, 2, 2)),
    "mask_rel_same_size": (_launches(2, 2), _launches(1, 2, 2)),
    "mask_rel_deep": (_launches(2, 2), _launches(1, 2, 2)),
    "mask_rel_mask_feature": (_launches(2, 2), _launches(1, 2, 2)),
    "mask_rel_same_predictor": (_launches(2, 2), _launches(1, 2, 2)),
    "rpn_only": (_launches(1, 0), _launches(0, 0, 0)),
    "mask_rcnn_c4": (_launches(2, 2), _launches(1, 2, 2)),
    "prcnn": (_launches(2, 5), _launches(1, 5, 5)),
    "remat": (_launches(2, 2), _launches(1, 2, 2)),
}
# the weights of a variant's forwards where seed 0's compare nothing or are
# ill-conditioned (under flax's truncated lecun_normal, on an H100 80GB
# HBM3): C4's seed-0 weights score no detection; remat's are the flagship's,
# whose CIAM turns the f32 kernels' float32 noise into 5e-3 of a mask
# probability (F32_FLAGSHIP_SEED). Steps keep seed 0
VARIANT_FORWARD_SEEDS = {"mask_rcnn_c4": 1, "remat": F32_FLAGSHIP_SEED}
# variants whose forward goes through run_inference (the host filter of
# set-NMS, the box-only paste of RPN_ONLY), besides the plain Mask R-CNN
SERVED = ("mask_rcnn_fpn", "set_nms", "rpn_only")
VARIANT_SUP_WARMUP, VARIANT_SUP_STEPS = 3, 5


def _count(calls):
    return {k: sum(key == k for key, _ in calls) for k in ("nms", "roi_align", "roi_align_backward")}


def _reset_counters():
    counters = {k: getattr(mod, attr) for k, (mod, attr, _) in kernel_wrappers().items()}
    for fn in counters.values():
        fn.launches = 0
    return counters


def _variant_serve(name, model, eval_ds):
    """``run_inference`` over the eval phase's windows, scored serially,
    with the model's own instances as gt; its launches and stats."""
    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.engine import inference as I

    items = own_instances_as_gt(model, eval_ds, BATCH, CANVAS, EVAL_MAX_GT)
    batches = make_test_loader(items, BATCH, CANVAS, max_gt=EVAL_MAX_GT, min_size=CANVAS, max_size=CANVAS,
                               raw_u8=True)
    counters = _reset_counters()
    result, timing = I.run_inference(model, batches, eval_workers=0)
    launches = {k: fn.launches for k, fn in counters.items()}
    n_batches = -(-len(items) // BATCH)
    want = {k: v * n_batches for k, v in VARIANT_LAUNCHES[name][0].items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} in run_inference over {n_batches} batches, expected {want}")
    bad = {m: v for m, per in result.items() for v in per.values() if not math.isfinite(v)}
    if bad or timing["images"] != len(items):
        raise AssertionError(f"{name}: {timing['images']} images, non-finite stats {bad}")
    scored(result, f"{name} run_inference")
    return launches, result, timing


def _variant_forward(name, model, x, sizes):
    """One warm forward (its kernel calls recorded) and one timed forward
    with synchronising calls made errors; the detections checked."""
    calls = []
    with recording(calls):
        model(x, sizes)
    torch.cuda.synchronize()
    if _count(calls) != VARIANT_LAUNCHES[name][0]:
        raise AssertionError(f"{name}: kernel calls in a forward {_count(calls)}, "
                             f"expected {VARIANT_LAUNCHES[name][0]}")
    counters = _reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        d = model(x, sizes)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != VARIANT_LAUNCHES[name][0]:
        raise AssertionError(f"{name}: launches in the timed forward {launches}")
    for f in ("boxes", "scores", "masks"):
        v = getattr(d, f)
        if v is not None and not torch.isfinite(v).all():
            raise AssertionError(f"{name}: non-finite {f}")
    if not bool(d.valid.any()):
        raise AssertionError(f"{name}: no valid detection")
    c = model.config
    if (d.masks is None) != (not c.mask_on) or (d.head_ids is None) != (c.nms_type != "set"):
        raise AssertionError(f"{name}: masks {d.masks is not None}, head_ids {d.head_ids is not None}")
    return calls, wall, launches, d


def _variant_train(name, trainer, batches, warmup, steps):
    """Supervised steps: ``warmup`` untimed (the last one's kernel calls
    recorded), then ``steps`` timed; launches counted over the timed ones."""
    calls = []
    for i in range(warmup):
        with recording(calls) if i == warmup - 1 else contextlib.nullcontext():
            trainer.step(batches[i % len(batches)])
    torch.cuda.synchronize()
    if _count(calls) != VARIANT_LAUNCHES[name][1]:
        raise AssertionError(f"{name}: kernel calls in a train step {_count(calls)}, "
                             f"expected {VARIANT_LAUNCHES[name][1]}")
    counters = _reset_counters()
    t = time.perf_counter()
    outs = [trainer.step(batches[i % len(batches)]) for i in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: v * steps for k, v in VARIANT_LAUNCHES[name][1].items()}
    if launches != want:
        raise AssertionError(f"{name}: launches in {steps} train steps {launches}, expected {want}")
    losses = {k: float(v) for k, v in outs[-1].items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    return calls, wall, launches, losses


def _variant_mt(trainer, dev):
    """The MT step of the plain Mask R-CNN: its teacher's pseudo-labels come
    from the greedy post-processor. VARIANT_SUP_WARMUP warm-up and MT_STEPS
    timed steps from START_MT + 1; MT_LAUNCHES a step."""
    from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                  unlabeled_to_torch)

    mt = trainer.mt
    max_gt = int(trainer.cfg.TPU.MAX_GT)
    labeled = [batch_to_torch(generate_batch(s, BATCH, image_size=CANVAS, max_instances=max_gt), dev) for s in range(2)]
    unlabeled = [unlabeled_to_torch(generate_unlabeled_batch(10 + s, BATCH, image_size=CANVAS, aug_k=mt.aug_k,
                                                             aug_s=mt.aug_s, max_instances=max_gt), dev)
                 for s in range(2)]
    trainer.iteration = mt.start_mt + 1
    calls = []
    for i in range(VARIANT_SUP_WARMUP):
        with recording(calls) if i == VARIANT_SUP_WARMUP - 1 else contextlib.nullcontext():
            trainer.step(labeled[i % 2], unlabeled[i % 2])
    torch.cuda.synchronize()
    if _count(calls) != MT_LAUNCHES:
        raise AssertionError(f"mask_rcnn_fpn: kernel calls in one MT step {_count(calls)}, expected {MT_LAUNCHES}")
    counters = _reset_counters()
    t = time.perf_counter()
    outs = [trainer.step(labeled[i % 2], unlabeled[i % 2]) for i in range(MT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != {k: v * MT_STEPS for k, v in MT_LAUNCHES.items()}:
        raise AssertionError(f"mask_rcnn_fpn: launches in {MT_STEPS} MT steps {launches}")
    losses = {k: float(v) for k, v in outs[-1].items()}
    if not all(math.isfinite(v) for v in losses.values()) or not {"mt_classifier", "mt_fg_loss"} <= set(losses):
        raise AssertionError(f"mask_rcnn_fpn MT losses {losses}")
    return calls, MT_STEPS * BATCH / wall, launches, losses


def variants_path(dev, stats, eval_ds):
    """Every variant at the flagship's width (1024 canvas, bf16, batch 4,
    weights from seed 0, the forwards' from ``VARIANT_FORWARD_SEEDS``):
    forwards, supervised steps and, for the plain Mask
    R-CNN, serving and MT steps; each kernel call of one forward and one
    step held against its plain version and timed."""
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.models.detector import model_from_cfg
    from mmt_psm_tpu_torch.models.variants import VARIANTS, variant_config
    from mmt_psm_tpu_torch.train import build_mt_trainer, build_trainer

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(BATCH, CANVAS, CANVAS, 3, generator=gen, device=dev) * 40.0
    sizes = torch.tensor([[CANVAS, CANVAS], [CANVAS, 900], [800, CANVAS], [700, 650]], dtype=torch.int32).to(dev)
    batches = [batch_to_torch(generate_batch(s, BATCH, image_size=CANVAS, max_instances=64), dev) for s in range(2)]
    rates, per_call_all = {}, {}
    for name in VARIANTS:
        t_v = time.perf_counter()
        path, opts = VARIANTS[name]
        model = model_from_cfg(variant_config(name), dev, seed=VARIANT_FORWARD_SEEDS.get(name, 0))
        calls, fwd_s, fwd_launches, d = _variant_forward(name, model, x, sizes)
        row = {"patches_per_s": BATCH / fwd_s, "valid_per_image": [int(v) for v in d.valid.sum(1)]}
        if name in SERVED:
            serve_launches, result, timing = _variant_serve(name, model, eval_ds)
            row.update(evaluated_patches_per_s=timing["images_per_sec"], AJI=result["AJI"], mAP=result["mAP"]["all"])
            fwd_launches = {k: fwd_launches[k] + serve_launches[k] for k in fwd_launches}
        del model, d
        plain_mask = name == "mask_rcnn_fpn"
        trainer = build_trainer(path, device=dev, seed=0, opts=opts)
        warm, steps = (VARIANT_SUP_WARMUP, VARIANT_SUP_STEPS) if plain_mask else (1, 1)
        t_calls, train_s, train_launches, losses = _variant_train(name, trainer, batches, warm, steps)
        row.update(images_per_s=steps * BATCH / train_s, losses=losses)
        del trainer
        launches = {k: fwd_launches[k] + train_launches[k] for k in fwd_launches}
        calls += t_calls
        if plain_mask:
            mt_trainer = build_mt_trainer(path, device=dev, seed=0, opts=opts)
            m_calls, mt_rate, mt_launches, mt_losses = _variant_mt(mt_trainer, dev)
            del mt_trainer
            row.update(mt_images_per_s=mt_rate, mt_losses=mt_losses)
            launches = {k: launches[k] + mt_launches[k] for k in launches}
            calls += m_calls
        timed, per_call = time_calls(calls, scaled=True)
        del calls, t_calls
        for k, (ms, plain_ms, b, err) in timed.items():
            stats[k].setdefault("variants", {})[name] = dict(
                launches=launches[k], ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err)
        for k in launches:  # a kernel the variant never launches
            if launches[k] == 0 and k not in timed:
                stats[k].setdefault("variants", {})[name] = dict(launches=0)
        per_call_all[name] = per_call
        rates[name] = row
        torch.cuda.empty_cache()
        print(f"variant {name} bf16 ({time.perf_counter() - t_v:.1f} s): {json.dumps(row)}; launches {launches}",
              flush=True)
    print("variants' kernel calls, each held against its plain version (kernel, shape, kernel ms, plain ms, "
          "max abs err, bound ms): " + json.dumps(per_call_all), flush=True)
    return rates


# the f32 comparison's detection limits: the flagship's (flagship_f32_vs_plain),
# boxes at 5e-3
VARIANT_DET_LIMITS = {"boxes": 5e-3, "scores": 1e-3, "masks": 1e-3}
# variants whose K3 shapes no earlier phase runs: their step is also held
# with K3 alone swapped, at K3_GRAD_RTOL
K3_ALONE = ("mask_rcnn_c4", "prcnn")


def variants_f32_vs_plain(dev):
    """Each variant at batch 2 in f32 with the kernels and with their plain
    versions: detections (valid, labels and head_ids identical), then one
    supervised step's losses and gradients."""
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.models.detector import model_from_cfg
    from mmt_psm_tpu_torch.models.variants import VARIANTS, variant_config
    from mmt_psm_tpu_torch.train import build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = kernel_wrappers()
    everything = ("nms", "roi_align", "roi_align_backward")
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, CANVAS, CANVAS, 3, generator=gen, device=dev) * 40.0
    sizes = torch.tensor([[CANVAS, CANVAS], [900, 1000]], dtype=torch.int32).to(dev)
    batch = batch_to_torch(generate_batch(7, 2, image_size=CANVAS, max_instances=64), dev)
    f32 = ["TPU.COMPUTE_DTYPE", "float32"]

    def swapped(names):
        stack = contextlib.ExitStack()
        for n in names:
            stack.enter_context(mock.patch.object(*plain[n]))
        return stack

    for name, (path, opts) in VARIANTS.items():
        t_v = time.perf_counter()
        model = model_from_cfg(variant_config(name, f32), dev, seed=VARIANT_FORWARD_SEEDS.get(name, 0))
        got = model(x, sizes)
        with swapped(everything):
            want = model(x, sizes)
        del model
        same = ["valid", "labels"] + (["head_ids"] if got.head_ids is not None else [])
        if not all(torch.equal(getattr(got, f), getattr(want, f)) for f in same):
            raise AssertionError(f"{name} f32 detections: {same} differ between kernels and plain versions")
        errs = {f: float((getattr(got, f) - getattr(want, f)).abs().max())
                for f in VARIANT_DET_LIMITS if getattr(got, f) is not None}
        over = {f: e for f, e in errs.items() if not e <= VARIANT_DET_LIMITS[f]}
        if over:
            raise AssertionError(f"{name} f32 detections differ beyond {VARIANT_DET_LIMITS}: {over}")
        line = f"detections {same} identical, max abs err {errs}"
        if VARIANT_LAUNCHES[name][1]["nms"]:  # RPN_ONLY's step launches no kernel

            def step(swap):
                trainer = build_trainer(path, device=dev, seed=0, opts=[*opts, *f32])
                if trainer.model.config.with_relation_nms:  # the geometric gate off its pole (see GRAD_RTOL)
                    with torch.no_grad():
                        trainer.model.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
                with swapped(swap):
                    losses = trainer.step(batch)
                return ({k: float(v) for k, v in losses.items()},
                        {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None})

            got_l, got_g = step(())
            for swap, rtol in [(everything, GRAD_RTOL)] + ([(("roi_align_backward",), K3_GRAD_RTOL)]
                                                           if name in K3_ALONE else []):
                want_l, want_g = step(swap)
                bad = {k: (got_l[k], want_l[k]) for k in want_l
                       if not abs(got_l[k] - want_l[k]) <= LOSS_RTOL * abs(want_l[k])}
                if bad:
                    raise AssertionError(f"{name} f32 step, {swap} plain: losses beyond {LOSS_RTOL}: {bad}")
                line += f"; {'+'.join(swap)} plain: losses within {LOSS_RTOL}, " + norm_diffs(
                    got_g, want_g, rtol, f"gradients ({'+'.join(swap)} plain)")
            del got_g, want_g
        torch.cuda.empty_cache()
        print(f"variant {name} f32 kernels vs plain ({time.perf_counter() - t_v:.1f} s): {line}", flush=True)
    torch.backends.cudnn.allow_tf32 = True


# --------------------------------------------------------- the datasets path
# the serving phase's windows and the model's own instances written twice: as
# a COCO-format split (labels 1 and 2 as the JSON's category ids 7 and 9, so an
# off-by-one id mapping shows) and as a Pascal VOC split whose class names
# have the labels' indexes
DATASET_CATEGORY_IDS = {1: 7, 2: 9}
VOC_NAMES = {1: "aeroplane", 2: "bicycle"}
DATASETS_VISUAL_NUM, DATASETS_TRAIN_ITERS, TTA_K = 2, 2, 2
# COCO segm AP on those gt: the exact half gives about 0.3 (see datasets_path);
# COCO AP against Papeval's mAP of the same images: a mask pixel that the
# forwards' float noise flips moves an IoU by under 1e-2
COCO_SEGM_AP_MIN, EVAL_STATS_ATOL = 0.25, 1e-2
# per batch of a forward: K1 for the RPN and relation-NMS, K2 for the box and
# mask heads; per supervised step K1 once, K2 and K3 twice
FORWARD_LAUNCHES = {"nms": 2, "roi_align": 2, "roi_align_backward": 0}
STEP_LAUNCHES = {"nms": 1, "roi_align": 2, "roi_align_backward": 2}


def write_coco_split(items, root):
    """``items`` (image, boxes, labels, masks) in the catalog's ``coco_*``
    layout: ``root/images/w<i>.png`` and ``root/annotations.json``, each
    mask as uncompressed RLE from the C++ library's column-major encoder."""
    import os

    import numpy as np
    from PIL import Image

    from mmt_psm_tpu_torch.evaluation._native import rle_encode

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    data = {"images": [], "annotations": [],
            "categories": [{"id": c, "name": f"class {lab}"} for lab, c in DATASET_CATEGORY_IDS.items()]}
    for i, it in enumerate(items):
        h, w = it["masks"].shape[1:]
        Image.fromarray(np.asarray(it["image"][:h, :w])).save(os.path.join(root, "images", f"w{i}.png"))
        data["images"].append({"id": i + 1, "file_name": f"w{i}.png", "height": int(h), "width": int(w)})
        for (x1, y1, x2, y2), lab, m in zip(it["boxes"].tolist(), it["labels"].tolist(), it["masks"]):
            data["annotations"].append({
                "id": len(data["annotations"]) + 1, "image_id": i + 1, "category_id": DATASET_CATEGORY_IDS[lab],
                "iscrowd": 0, "area": int(np.count_nonzero(m)), "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                "segmentation": {"size": [int(h), int(w)], "counts": rle_encode(m).tolist()}})
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump(data, f)


def write_voc_split(items, root, split="test"):
    """``items`` as a Pascal VOC split: JPEGs, XML boxes (1-based pixel
    indexes, as VOC writes them) named by ``VOC_NAMES``, none difficult."""
    import os

    import numpy as np
    from PIL import Image

    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, it in enumerate(items):
        h, w = it["image"].shape[:2]
        Image.fromarray(np.asarray(it["image"])).save(os.path.join(root, "JPEGImages", f"w{i}.jpg"))
        objs = "".join(
            f"<object><name>{VOC_NAMES[lab]}</name><difficult>0</difficult><bndbox><xmin>{int(x1) + 1}</xmin>"
            f"<ymin>{int(y1) + 1}</ymin><xmax>{int(x2) + 1}</xmax><ymax>{int(y2) + 1}</ymax></bndbox></object>"
            for (x1, y1, x2, y2), lab in zip(it["boxes"].tolist(), it["labels"].tolist()))
        with open(os.path.join(root, "Annotations", f"w{i}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>{objs}"
                    f"</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"), "w") as f:
        f.write("".join(f"w{i}\n" for i in range(len(items))))


def predictions_of(model, ds, batch, canvas):
    """One prediction dict an item of ``ds`` (boxes, scores, labels, valid,
    float16-rounded mask probabilities widened to f32, image_hw), from the
    engine's device stage: what ``evaluation.evaluate`` takes."""
    import numpy as np

    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.engine.inference import DeviceStage

    stage, preds = DeviceStage(model), []
    for b in make_test_loader(ds, batch, canvas, max_gt=EVAL_MAX_GT, min_size=canvas, max_size=canvas, raw_u8=True):
        boxes, scores, labels, valid, masks, _ = stage.fetch(stage.dispatch(b))
        for i in range(b["n_real"]):
            preds.append({"boxes": boxes[i], "scores": scores[i], "labels": labels[i], "valid": valid[i],
                          "masks": masks[i].astype(np.float32), "image_hw": tuple(b["image_size"][i].tolist())})
    return preds


def datasets_path(dev, stats, eval_ds):
    """The serve CLI, the dataset-level evaluators and the train CLI over
    COCO-format, VOC and concatenated datasets at the flagship's width
    (1024 canvas, bf16, batch 4, seed-0 weights), with overlays, .mat export
    and a TTA batch; every kernel call recorded, each sub-run's launches
    counted from 0, then every call held against its plain version."""
    import os
    import tempfile

    import numpy as np

    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.data.catalog import DatasetCatalog, build_datasets
    from mmt_psm_tpu_torch.data.coco import COCODataset
    from mmt_psm_tpu_torch.data.concat import ConcatDataset
    from mmt_psm_tpu_torch.data.loader import make_test_loader, make_tta_loader
    from mmt_psm_tpu_torch.data.voc import PascalVOCDataset
    from mmt_psm_tpu_torch.engine import inference as I
    from mmt_psm_tpu_torch.evaluation import evaluate
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG
    from mmt_psm_tpu_torch.tools import test_net, train_mean_teacher
    from mmt_psm_tpu_torch.utils.checkpoint import Checkpointer

    model = build_model(device=dev, seed=0)
    t = time.perf_counter()
    items = own_instances_as_gt(model, eval_ds, BATCH, CANVAS, EVAL_MAX_GT)
    calls, launches, runs = [], {}, {}

    def counted(name, want, fn):
        """``fn()`` with every count set to 0 just before it and read just
        after (the counts sit on the recorders)."""
        counters = _reset_counters()
        t_run = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[name] = time.perf_counter() - t_run
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        if launches[name] != want:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {want}")
        return out

    def times(n, per):
        return {k: n * v for k, v in per.items()}

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(DatasetCatalog, "DATA_DIR", tmp), \
            mock.patch.dict(DatasetCatalog.DATASETS, {"voc_syn": {"factory": "PascalVOCDataset", "split": "test",
                                                                  "data_dir": os.path.join(tmp, "voc")}}):
        write_coco_split(items, os.path.join(tmp, "coco_syn"))
        write_voc_split(items, os.path.join(tmp, "voc"))
        ckpt_dir = os.path.join(tmp, "ckpt")
        Checkpointer(ckpt_dir).save("model_0000000", {"model": model.state_dict()})
        write_s = time.perf_counter() - t
        coco_ds, voc_ds = build_datasets("coco_syn"), build_datasets(("voc_syn",))
        served = build_datasets(("coco_syn", "synthetic_val"))
        if not (isinstance(coco_ds, COCODataset) and isinstance(voc_ds, PascalVOCDataset)
                and isinstance(served, ConcatDataset) and len(coco_ds) == len(voc_ds) == len(items)):
            raise AssertionError(f"catalog: {type(coco_ds).__name__}, {type(voc_ds).__name__}, "
                                 f"{type(served).__name__}")
        if coco_ds.json_category_id_to_contiguous_id != {7: 1, 9: 2}:
            raise AssertionError(f"category ids {coco_ds.json_category_id_to_contiguous_id}")
        n_served = -(-len(served) // BATCH)
        n_coco = -(-len(coco_ds) // BATCH)
        with recording(calls):
            # serving: the test CLI over the concatenation, overlays and .mat export on
            out_dir = os.path.join(tmp, "out")
            rows = counted("test CLI", times(n_served, FORWARD_LAUNCHES), lambda: test_net.main([
                "--config-file", FLAGSHIP_CONFIG, "--ckpt-dir", ckpt_dir, "--output-dir", out_dir,
                "TEST.IMS_PER_BATCH", str(BATCH), "TEST.EVAL_WORKERS", "0", "DATASETS.MODE_IN_TEST", "test",
                "DATASETS.TEST", '("coco_syn", "synthetic_val")', "TEST.VISUAL_NUM", str(DATASETS_VISUAL_NUM),
                "TEST.GEN", "True"]))
            # the COCO split alone through the engine, scored serially: its rate
            coco_stats, coco_timing = counted("COCO sweep", times(n_coco, FORWARD_LAUNCHES), lambda: I.run_inference(
                model, make_test_loader(coco_ds, BATCH, CANVAS, max_gt=EVAL_MAX_GT, min_size=CANVAS,
                                        max_size=CANVAS, raw_u8=True), eval_workers=0))
            preds = counted("predictions", times(n_coco, FORWARD_LAUNCHES),
                            lambda: predictions_of(model, coco_ds, BATCH, CANVAS))
            tta = next(make_tta_loader(coco_ds, BATCH, CANVAS, tta_k=TTA_K, max_gt=EVAL_MAX_GT, min_size=CANVAS,
                                       max_size=CANVAS))
            sizes = torch.from_numpy(tta["image_size"]).to(dev)
            tta_dets = counted("TTA", times(TTA_K, FORWARD_LAUNCHES), lambda: [
                model(torch.from_numpy(tta["tta_views"][:, k]).to(dev), sizes) for k in range(TTA_K)])
            # training: supervised iterations (START_MT above MAX_ITER) on a concatenation
            run_dir = os.path.join(tmp, "run")
            trained = counted("train CLI", times(DATASETS_TRAIN_ITERS, STEP_LAUNCHES), lambda: train_mean_teacher.main([
                "--skip-test", "--output-dir", run_dir, "DATASETS.TRAIN", '("coco_syn", "synthetic_train")',
                "DATASETS.NO_LABEL", "False", "MT.START_MT", str(DATASETS_TRAIN_ITERS + 10),
                "SOLVER.MAX_ITER", str(DATASETS_TRAIN_ITERS), "TEST.EVAL_WORKERS", "0"]))

        row = rows["model_0000000"]
        if set(row) != RESULT_KEYS:
            raise AssertionError(f"result.json keys {sorted(row)}")
        with open(os.path.join(out_dir, "result.json")) as f:
            if json.load(f) != rows:
                raise AssertionError("result.json differs from the CLI's rows")
        vis = sorted(os.listdir(os.path.join(out_dir, "vis_model_0000000")))
        mats = sorted(os.listdir(os.path.join(out_dir, "mat_model_0000000")))
        if vis != [f"vis_{i:04d}.png" for i in range(DATASETS_VISUAL_NUM)] or len(mats) != len(served):
            raise AssertionError(f"overlays {vis}, {len(mats)} .mat files for {len(served)} images")
        scored(coco_stats, "COCO sweep")
        if len(preds) != len(coco_ds):
            raise AssertionError(f"{len(preds)} predictions for {len(coco_ds)} images")
        coco = {t_: evaluate(coco_ds, preds, iou_type=t_) for t_ in ("segm", "bbox")}
        voc = evaluate(voc_ds, preds)
        finite = [v for r in coco.values() for k, v in r.items() if k != "AP_per_class"] + [voc["map"]]
        # every other gt instance is its detection moved 2 px, which a random-weight
        # mask matches at IoU 0.3-0.5 only: segm AP sits near 0.3, not above 0.5
        if not all(math.isfinite(v) for v in finite) or not coco["segm"]["AP"] > COCO_SEGM_AP_MIN:
            raise AssertionError(f"COCO {coco}, VOC mAP {voc['map']}: expected finite, segm AP above "
                                 f"{COCO_SEGM_AP_MIN}")
        # the COCO evaluator at Papeval's max_dets (200) against Papeval's mAP of
        # the sweep's own forward of the same images: the same AP by two evaluators
        papeval_ap = evaluate(coco_ds, preds, iou_type="segm", max_dets=200)["AP"]
        if not abs(papeval_ap - coco_stats["mAP"]["all"]) <= EVAL_STATS_ATOL:
            raise AssertionError(f"COCO segm AP {papeval_ap} against Papeval's mAP {coco_stats['mAP']['all']}")
        if not np.array_equal(tta["tta_views"][:, 0], tta["image"]):
            raise AssertionError("TTA view 0 is not the batch's image")
        for d in tta_dets:
            if not (torch.isfinite(d.boxes).all() and torch.isfinite(d.masks).all() and bool(d.valid.any())):
                raise AssertionError("TTA view: non-finite or no valid detection")
        loop = trained["trainer"]
        losses = {k: list(m.deque) for k, m in loop.meters.meters.items() if k != "time"}
        if len(losses["loss_total"]) != DATASETS_TRAIN_ITERS or "mt_weight" in losses or \
                not all(math.isfinite(x) for v in losses.values() for x in v):
            raise AssertionError(f"train CLI losses {losses}")
        width = loop.steps.model.config
        if (width.image_size, width.compute_dtype, int(loop.cfg.SOLVER.IMS_PER_BATCH)) != (CANVAS, "bfloat16", BATCH):
            raise AssertionError(f"not the flagship's width: {width.image_size} {width.compute_dtype}")
        train_s = sum(loop.meters.meters["time"].deque)
    # every recorded call held against its plain version; one of each shape timed
    t = time.perf_counter()
    errs, firsts = {}, {}
    for i, (key, a) in enumerate(calls):
        shape, err = held_against_plain(key, a)
        errs[key] = max(errs.get(key, 0.0), err)
        firsts.setdefault((key, shape), i)
    n_calls = len(calls)
    timed, per_call = time_calls([calls[i] for i in firsts.values()])
    del calls
    check_s = time.perf_counter() - t
    total = {k: sum(v[k] for v in launches.values()) for k in FORWARD_LAUNCHES}
    for k, v in total.items():
        stats[k]["launches_datasets"] = v
    print(f"datasets bf16: {len(items)} windows of {CANVAS}px written as a COCO split (categories "
          f"{DATASET_CATEGORY_IDS}, RLE) and a VOC split ({VOC_NAMES}) in {write_s:.3f} s; test CLI over "
          f"coco_syn + synthetic_val ({len(served)} images, {DATASETS_VISUAL_NUM} overlays, {len(mats)} .mat) in "
          f"{runs['test CLI']:.3f} s: {json.dumps(row)}; launches {json.dumps(launches)}", flush=True)
    print(f"datasets bf16 evaluation: COCO segm AP/AP50/AP75 {coco['segm']['AP']}/{coco['segm']['AP50']}/"
          f"{coco['segm']['AP75']}, bbox {coco['bbox']['AP']}/{coco['bbox']['AP50']}/{coco['bbox']['AP75']}; "
          f"at max_dets 200 {papeval_ap} (Papeval's mAP of the sweep {coco_stats['mAP']['all']}); "
          f"VOC mAP {voc['map']} (AP by class {voc['ap'].tolist()}); Papeval of the COCO sweep "
          f"{json.dumps(coco_stats)}; TTA {TTA_K} views, valid per image "
          f"{[[int(v) for v in d.valid.sum(1)] for d in tta_dets]}", flush=True)
    print(f"datasets bf16 kernel calls: {n_calls}, each held against its plain version (max abs err "
          f"{json.dumps(errs)}) in {check_s:.3f} s; one of each shape (kernel, shape, kernel ms, plain ms, max abs "
          f"err, bound ms): {json.dumps(per_call)}", flush=True)
    print(f"datasets bf16 train CLI: {DATASETS_TRAIN_ITERS} supervised iterations on coco_syn + synthetic_train at "
          f"{CANVAS}px, batch {BATCH}: {DATASETS_TRAIN_ITERS * BATCH / train_s:.3f} images/s over its iterations "
          f"({train_s:.3f} s, the first with its wait for a batch), losses {json.dumps(losses)}", flush=True)
    return coco_timing, DATASETS_TRAIN_ITERS * BATCH / train_s, timed


# --------------------------------------------------------- data parallel
# two ranks on cuda:0 over gloo (NCCL refuses two ranks on one device), the
# flagship at full width: a global batch of BATCH, BATCH // DP_WORLD a rank
DP_WORLD, DP_STEPS, DP_EVAL_BATCH = 2, 3, 2
DP_GROUP_TIMEOUT_S, DP_JOIN_TIMEOUT_S = 300, 900
# per rank and step, the single-card counts: K1 for the RPN, K2 and K3 for the
# box and mask heads (supervised); MT_LAUNCHES (mean teacher)
DP_LAUNCHES = {"sup": STEP_LAUNCHES, "mt": MT_LAUNCHES}


def _world_one():
    """The helpers of ``parallel/comm.py`` read the world size at each call:
    with it read as 1, a rank computes what one process computes."""
    from mmt_psm_tpu_torch.parallel import comm

    return mock.patch.multiple(comm, get_world_size=lambda: 1, get_rank=lambda: 0)


def _packed(items):
    import numpy as np

    return [dict(it, masks=np.packbits(it["masks"], axis=-1), width=it["masks"].shape[-1]) for it in items]


def _unpacked(items):
    import numpy as np

    return [{**{k: v for k, v in it.items() if k != "width"},
             "masks": np.unpackbits(it["masks"], axis=-1, count=it["width"])} for it in items]


def _dp_losses(losses):
    """The global batch's losses, as the loop sums them (``comm.global_losses``)."""
    from mmt_psm_tpu_torch.engine.trainer import REPLICATED
    from mmt_psm_tpu_torch.parallel import comm

    return {k: float(v) for k, v in comm.global_losses(losses, REPLICATED).items()}


def _ranks_identical(state):
    flat = torch.cat([v.reshape(-1).float() for v in state.values()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0)
    same = torch.tensor([int(torch.equal(flat, ref))], device=flat.device)
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item())


def _dp_f32(dev, rank, mesh, opts, batch=BATCH):
    """One supervised step at START_MT and one MT step at the ramp's plateau,
    f32, TF32 off, on the global batch sharded over the ranks, each held
    against the same step of one process on the global batch (rank 0 checks
    the supervised step, rank 1 the MT step, both references computed side
    by side first): losses to LOSS_RTOL relative, the updated student and
    teacher to LOSS_RTOL of each tensor's norm (``norm_diffs``), the ranks'
    tensors bit-identical. cuDNN is off here: it picks its convolution by
    the batch size, and the float32 rounding of another algorithm moves the
    teacher's spreads enough to swap two of PSM's hard negatives at the
    n_pos // 2 cut (2e-4 relative on ``mt_classifier`` in a CPU rehearsal
    with oneDNN, whose blocking moves the same way); PyTorch's own CUDA
    convolution computes each image alone, so the two runs differ by the
    order of the sums the data parallelism changes."""
    from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                  unlabeled_to_torch)
    from mmt_psm_tpu_torch.parallel.mesh import shard_batch
    from mmt_psm_tpu_torch.train import build_mt_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lab = generate_batch(20, batch, image_size=CANVAS, max_instances=64)
    unl = generate_unlabeled_batch(21, batch, image_size=CANVAS, max_instances=64)

    def run(kind, m):
        trainer = build_mt_trainer(device=dev, seed=0, opts=[*opts, "TPU.COMPUTE_DTYPE", "float32"])
        with torch.no_grad():  # the relation head's geometric gate off its pole (see GRAD_RTOL)
            for model in (trainer.model, trainer.teacher):
                model.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
        mt = trainer.mt
        trainer.iteration = mt.start_mt if kind == "sup" else mt.start_mt + mt.rampup_step
        labeled = batch_to_torch(shard_batch(lab, m), dev)
        losses = (trainer.step(labeled) if kind == "sup"
                  else trainer.step(labeled, unlabeled_to_torch(shard_batch(unl, m), dev)))
        out = {"losses": _dp_losses(losses), "student": {k: v.detach().clone() for k, v in
                                                         trainer.model.state_dict().items()},
               "teacher": {k: v.detach().clone() for k, v in trainer.teacher.state_dict().items()}}
        del trainer
        torch.cuda.empty_cache()
        return out

    from mmt_psm_tpu_torch.parallel.mesh import Mesh

    kinds = ("sup", "mt")
    if rank < len(kinds):
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False), _world_one():
            ref = run(kinds[rank], Mesh(1, 0, dev, None))
    lines = {}
    for i, kind in enumerate(kinds):
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            got = run(kind, mesh)
        identical = _ranks_identical(got["student"]) and _ranks_identical(got["teacher"])
        if not identical:
            raise AssertionError(f"data parallel f32 {kind} step: the ranks' tensors differ")
        if i != rank:
            continue
        bad = {k: (v, ref["losses"][k]) for k, v in got["losses"].items()
               if not abs(v - ref["losses"][k]) <= LOSS_RTOL * abs(ref["losses"][k])}
        if bad or set(got["losses"]) != set(ref["losses"]):
            raise AssertionError(f"data parallel f32 {kind} step: losses differ from one process beyond "
                                 f"{LOSS_RTOL} relative: {bad}")
        rel = {k: abs(v - ref["losses"][k]) / max(abs(ref["losses"][k]), 1e-30) for k, v in got["losses"].items()}
        try:
            tensors = (norm_diffs(got["student"], ref["student"], LOSS_RTOL, "student tensors") + "; "
                       + norm_diffs(got["teacher"], ref["teacher"], LOSS_RTOL, "teacher tensors"))
        except AssertionError as e:
            raise AssertionError(f"data parallel f32 {kind} step over {mesh.world} ranks: {e}; the losses' "
                                 f"relative differences {rel}") from e
        lines[kind] = (f"{kind}: losses within {LOSS_RTOL} relative of one process (max {max(rel.values()):.3g}); "
                       + tensors + "; the ranks bit-identical")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    return lines


def _dp_bf16(dev, mesh, opts, batch=BATCH):
    """DP_STEPS timed supervised and MT steps (bf16) at a global batch of
    ``batch`` after one warm step of each whose kernel calls are recorded and
    held against their plain versions (on rank 0 also timed, ``time_calls``,
    while rank 1 waits in a barrier); the launches of the timed steps, the
    labeled images/s and the gradient all-reduce's ms."""
    from mmt_psm_tpu_torch.data.synthetic import (batch_to_torch, generate_batch, generate_unlabeled_batch,
                                                  unlabeled_to_torch)
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.parallel.mesh import shard_batch
    from mmt_psm_tpu_torch.train import build_mt_trainer

    trainer = build_mt_trainer(device=dev, seed=0, opts=opts)
    mt = trainer.mt
    labeled = [batch_to_torch(shard_batch(generate_batch(s, batch, image_size=CANVAS, max_instances=64), mesh), dev)
               for s in range(2)]
    unlabeled = [unlabeled_to_torch(shard_batch(generate_unlabeled_batch(10 + s, batch, image_size=CANVAS,
                                                                         max_instances=64), mesh), dev)
                 for s in range(2)]
    out = {"images_per_rank": int(labeled[0]["image"].shape[0])}
    for kind, start in (("sup", 0), ("mt", mt.start_mt + 1)):
        trainer.iteration = start
        args = lambda i: (labeled[i % 2],) + ((unlabeled[i % 2],) if kind == "mt" else ())  # noqa: E731
        calls = []
        with recording(calls):
            trainer.step(*args(0))
        torch.cuda.synchronize()
        found = _count(calls)
        if found != DP_LAUNCHES[kind]:
            raise AssertionError(f"kernel calls in one data-parallel {kind} step: {found}, "
                                 f"expected {DP_LAUNCHES[kind]}")
        errs, timed = {}, None
        if mesh.rank == 0:
            comm.synchronize()  # the other rank's checks are done: the card is this rank's to time
            timed, per_call = time_calls(calls)
            errs = {k: v[3] for k, v in timed.items()}
            timed = {k: {"ms": v[0], "plain_ms": v[1], **v[2], "calls": [c[1] for c in per_call if c[0] == k]}
                     for k, v in timed.items()}
            comm.synchronize()
        else:
            for key, a in calls:
                errs[key] = max(errs.get(key, 0.0), held_against_plain(key, a)[1])
            comm.synchronize()
            comm.synchronize()
        del calls
        counters = _reset_counters()
        t = time.perf_counter()
        outs = [trainer.step(*args(i + 1)) for i in range(DP_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        expected = {k: v * DP_STEPS for k, v in DP_LAUNCHES[kind].items()}
        if launches != expected:
            raise AssertionError(f"kernel launches in {DP_STEPS} data-parallel {kind} steps: {launches}, "
                                 f"expected {expected}")
        losses = _dp_losses(outs[-1])
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"data-parallel {kind} losses {losses}")
        out[kind] = {"seconds": wall, "launches": launches, "max_abs_err": errs, "losses": losses, "timed": timed}
    # the gradient bucket of the last step, summed again: its all-reduce alone
    tensors = trainer.clip_tensors
    n = sum(t.numel() for t in tensors)
    for _ in range(2):
        comm.all_reduce_grads_(tensors)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(DP_STEPS):
        comm.all_reduce_grads_(tensors)
    torch.cuda.synchronize()
    out["allreduce"] = {"ms": (time.perf_counter() - t) * 1e3 / DP_STEPS, "elements": n}
    return out


def _dp_eval(dev, rank, world, items_path, opts):
    """``run_inference`` over this rank's ShardSampler share of the eval
    windows at TEST.IMS_PER_BATCH DP_EVAL_BATCH: the whole split's stats."""
    import pickle

    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.data.samplers import ShardSampler
    from mmt_psm_tpu_torch.engine.inference import run_inference

    with open(items_path, "rb") as f:
        items = _unpacked(pickle.load(f))
    model = build_model(device=dev, seed=0, opts=opts)
    shard = ShardSampler(len(items), world, rank, shuffle=False)
    loader = make_test_loader(items, DP_EVAL_BATCH, CANVAS, max_gt=EVAL_MAX_GT, min_size=CANVAS, max_size=CANVAS,
                              raw_u8=True, indices=shard)
    stats, timing = run_inference(model, loader, eval_workers=0)
    return {"stats": stats, "images": timing["images"], "seconds": timing["seconds"]}


def _dp_nccl(dev, store, opts):
    """A one-rank NCCL group on the card, through the collectives' own path:
    ``comm.distributed`` read as true, so every helper issues its NCCL
    collective in the group of one. Two supervised steps, the second with
    synchronising calls made errors: the step's sums, row gathers and k-th
    (all-reduces) and its gradient bucket's all-reduce. Then the loop's
    loss sum, the eval merge's ``all_gather_object`` and the checkpoint
    barrier. The first step's losses are held against the same step of a
    trainer from the same seed without collectives (LOSS_RTOL: the batch
    mean's sum over a count rounds apart from ``mean``). Returns the second
    step's losses and the collectives counted."""
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.engine.trainer import REPLICATED
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.train import build_trainer

    batches = [batch_to_torch(generate_batch(s, BATCH, image_size=CANVAS, max_instances=64), dev) for s in (0, 1)]
    plain = build_trainer(device=dev, seed=0, opts=opts)
    want = {k: float(v) for k, v in plain.step(batches[0]).items()}
    del plain
    torch.cuda.empty_cache()
    comm.init_distributed("nccl", dev, rank=0, world_size=1, init_method=f"file://{store}",
                          timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    dist = torch.distributed
    counts = {"all_reduce": 0, "all_gather_object": 0, "barrier": 0}

    def counted(name):
        fn = getattr(dist, name)

        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"not a one-rank NCCL group: {dist.get_backend()}, {dist.get_world_size()}")
        with mock.patch.object(comm, "distributed", lambda: True), \
                mock.patch.multiple(dist, **{k: counted(k) for k in counts}):
            trainer = build_trainer(device=dev, seed=0, opts=opts)
            first = {k: float(v) for k, v in trainer.step(batches[0]).items()}
            bad = {k: (v, want[k]) for k, v in first.items() if not abs(v - want[k]) <= LOSS_RTOL * abs(want[k])}
            if bad or set(first) != set(want):
                raise AssertionError(f"NCCL world-1 step: losses beyond {LOSS_RTOL} of the step without "
                                     f"collectives: {bad}")
            torch.cuda.synchronize()
            before = dict(counts)
            torch.cuda.set_sync_debug_mode("error")
            try:
                losses = trainer.step(batches[1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            step = counts["all_reduce"] - before["all_reduce"]
            if step < 2 or counts["all_gather_object"] or counts["barrier"]:
                raise AssertionError(f"NCCL world-1 step: collectives {counts}, {step} all-reduces in the step")
            losses = {k: float(v) for k, v in comm.global_losses(losses, REPLICATED).items()}
            if comm.all_gather({"rank": 0}) != [{"rank": 0}]:
                raise AssertionError("NCCL world-1 all_gather")
            comm.synchronize()
            torch.cuda.synchronize()
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"NCCL world-1 losses {losses}")
        worst = max(abs(v - want[k]) / max(abs(want[k]), 1e-30) for k, v in first.items())
        return {"losses": losses, "step_all_reduces": step, "collectives": counts, "first_step_rel": worst}
    finally:
        dist.destroy_process_group()


def dp_rank(rank, world, backend, device, tmp, items_path, opts, batch):
    """One rank of a data-parallel world on ``device`` (LOCAL_RANK its
    index), the configs the flagship's plus ``opts``, a global batch of
    ``batch``; its results in ``tmp``. Over gloo, rank 0 then runs the
    one-rank NCCL group."""
    import os
    import pickle
    import traceback

    from mmt_psm_tpu_torch.ops import kernels
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.parallel.mesh import current_mesh

    try:
        kernels.build_all()  # built by the parent: loads them
        os.environ["LOCAL_RANK"] = str(torch.device(device).index or 0)
        dev = comm.init_distributed(backend, device, rank=rank, world_size=world, init_method=f"file://{tmp}/store",
                                    timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
        mesh = current_mesh(dev)
        out = {}
        t = time.perf_counter()
        out["f32"] = _dp_f32(dev, rank, mesh, opts, batch)
        out["f32_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        out["bf16"] = _dp_bf16(dev, mesh, opts, batch)
        out["bf16_seconds"] = time.perf_counter() - t
        out["eval"] = _dp_eval(dev, rank, world, items_path, opts)
        comm.synchronize()
        torch.distributed.destroy_process_group()
        if rank == 0 and backend == "gloo":
            out["nccl"] = _dp_nccl(dev, f"{tmp}/store_nccl", opts)
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def data_parallel_path(dev, stats, opts=(), backend="gloo", devices=None, batch=BATCH):
    """The data-parallel phase: a rank spawned on each of ``devices`` (by
    default DP_WORLD on ``dev``) joining a ``backend`` group, each running
    ``dp_rank`` on a global batch of ``batch``; a rank that fails or hangs
    fails the phase (every rank is then killed). Against one process on
    ``dev`` here: the sharded eval's stats (EVAL_STATS_ATOL). ``opts``:
    overrides of the flagship config (a rehearsal at a small size)."""
    import multiprocessing as mp
    import os
    import pickle
    import tempfile

    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
    from mmt_psm_tpu_torch.engine.inference import run_inference

    model = build_model(device=dev, seed=0, opts=opts)
    items = own_instances_as_gt(model, synthetic_slide_dataset(**EVAL_SLIDES), BATCH, CANVAS, EVAL_MAX_GT)
    want, _ = run_inference(model, make_test_loader(items, DP_EVAL_BATCH, CANVAS, max_gt=EVAL_MAX_GT, min_size=CANVAS,
                                                    max_size=CANVAS, raw_u8=True), eval_workers=0)
    del model
    torch.cuda.empty_cache()
    devices = [str(dev)] * DP_WORLD if devices is None else list(devices)
    world = len(devices)
    with tempfile.TemporaryDirectory() as tmp:
        items_path = os.path.join(tmp, "items.pkl")
        with open(items_path, "wb") as f:
            pickle.dump(_packed(items), f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dp_rank, args=(r, world, backend, d, tmp, items_path, list(opts), batch))
                 for r, d in enumerate(devices)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + DP_JOIN_TIMEOUT_S
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.5)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                errs = "".join(open(os.path.join(tmp, f"rank{r}.err")).read() for r in failed
                               if os.path.exists(os.path.join(tmp, f"rank{r}.err")))
                raise AssertionError(f"data parallel: rank(s) {failed} failed or did not finish in "
                                     f"{DP_JOIN_TIMEOUT_S} s (exit codes {[p.exitcode for p in procs]}):\n{errs}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        wall = time.perf_counter() - t
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, out in enumerate(ranks):
        for kind, line in out["f32"].items():
            print(f"data parallel f32 rank {r} {line}", flush=True)
    for r, out in enumerate(ranks):
        b = out["bf16"]
        print(f"data parallel bf16 rank {r}: {b['images_per_rank']} of {batch} images a step; "
              + "; ".join(f"{kind}: {DP_STEPS} steps in {b[kind]['seconds']:.3f} s, "
                          f"{DP_STEPS * b['images_per_rank'] / b[kind]['seconds']:.3f} labeled images/s on this rank "
                          f"({DP_STEPS * batch / b[kind]['seconds']:.3f} for the global batch), launches "
                          f"{json.dumps(b[kind]['launches'])} (expected {json.dumps(DP_LAUNCHES[kind])} a step), "
                          f"recorded calls' max abs err against the plain versions "
                          f"{json.dumps(b[kind]['max_abs_err'])}, "
                          f"global losses {json.dumps(b[kind]['losses'])}" for kind in ("sup", "mt"))
              + f"; gradient all-reduce over {backend} of {b['allreduce']['elements']} elements: "
                f"{b['allreduce']['ms']:.3f} ms", flush=True)
    for kind in ("sup", "mt"):
        print(f"data parallel bf16 rank 0 {kind} step's kernel calls at {ranks[0]['bf16']['images_per_rank']} "
              f"images, device ms summed over the step's calls: "
              + "; ".join(f"{k} ({', '.join(t['calls'])}) {t['ms']:.4f}, plain {t['plain_ms']:.3f}, bound "
                          f"{t['bound_ms']:.5f} ({t['bound_by']})"
                          for k, t in ranks[0]["bf16"][kind]["timed"].items()), flush=True)
    if any(o["bf16"]["sup"]["losses"] != ranks[0]["bf16"]["sup"]["losses"] for o in ranks):
        raise AssertionError("data parallel: the ranks log other global losses")
    for r, out in enumerate(ranks):
        got = out["eval"]["stats"]
        diff = {f"{m}/{c}": (got[m][c], want[m][c]) for m in ("AJI", "F1", "DSC", "mAP") for c in want[m]
                if not abs(got[m][c] - want[m][c]) <= EVAL_STATS_ATOL}
        if diff or sum(o["eval"]["images"] for o in ranks) != len(items):
            raise AssertionError(f"data parallel eval rank {r}: {out['eval']['images']} images, stats beyond "
                                 f"{EVAL_STATS_ATOL} of one process: {diff}")
    scored({"AJI": want["AJI"], "mAP": want["mAP"]}, "data parallel eval")
    print(f"data parallel eval: {len(items)} windows over {world} ranks at batch {DP_EVAL_BATCH}, "
          f"{[o['eval']['images'] for o in ranks]} images a rank in {[round(o['eval']['seconds'], 3) for o in ranks]} "
          f"s; AJI/F1/DSC/mAP within {EVAL_STATS_ATOL} of one process at batch {DP_EVAL_BATCH} "
          f"({json.dumps({m: want[m] for m in ('AJI', 'F1', 'DSC', 'mAP')})})", flush=True)
    if "nccl" in ranks[0]:
        nc = ranks[0]["nccl"]
        print(f"data parallel NCCL world 1, every helper's collective issued: a supervised step with "
              f"synchronising calls made errors, {nc['step_all_reduces']} all-reduces in it, losses "
              f"{json.dumps(nc['losses'])}; the warm step's losses within {nc['first_step_rel']:.3g} relative of "
              f"the step without collectives; collectives in all {json.dumps(nc['collectives'])}", flush=True)
    shared = len(set(devices)) < world
    print(f"data parallel: {world} ranks on {sorted(set(devices))} over {backend} in {wall:.3f} s (f32 checks "
          f"{[round(o['f32_seconds'], 3) for o in ranks]} s, bf16 runs {[round(o['bf16_seconds'], 3) for o in ranks]} "
          f"s)" + ("; ranks sharing one card say nothing of scaling over cards" if shared else ""), flush=True)
    for k in ("nms", "roi_align", "roi_align_backward"):
        # rank 0's launches over its timed supervised and MT steps
        stats[k]["launches_dp"] = sum(ranks[0]["bf16"][kind]["launches"][k] for kind in ("sup", "mt"))
    return ranks


# ------------------------------------------------------ the learning tools
# the lift tool at the lift's 256-px windows: its sup and mt arms, 40
# iterations each, MT from iteration 20, on 16 unlabeled patches; then the
# convergence tool, 20 iterations
LEARN_LIFT = ["--size", "256", "--iters", "40", "--start-mt", "20", "--arms", "sup,mt", "--unlabeled-patches", "16",
              "--sharpen", "--hard-neg", "--tag", "smoke"]
LEARN_CONVERGENCE_ITERS = 20
LIFT_ARM_KEYS = {"AJI_cyto", "AJI_nuclei", "mAP_all", "AP50_all", "F1_nuclei"}
LIFT_META_KEYS = {"seed", "size", "canvas", "iters", "start_mt", "lambda", "alpha", "fg_hint", "train_ratio",
                  "labeled_windows", "unlabeled_patches", "total_seconds", "card"}
CONVERGENCE_KEYS = {"iters", "train_seconds", "sec_per_iter", "AJI", "F1", "mAP_all", "AP50_all",
                    "eval_images_per_sec", "card"}


def call_shape(key, a):
    """The shapes that tell one kernel call of a path from another."""
    if key == "nms":
        return key, tuple(a[0].shape)
    if key == "roi_align":
        return key, tuple(a[1].shape), a[3], tuple(tuple(f.shape) for f in a[0]), a[0][0].dtype
    return key, tuple(a[0].shape), tuple(a[1].shape), a[4]


class FirstOfEachShape:
    """A call list for ``recording`` that keeps the first call of each shape
    (``call_shape``) only: a path of thousands of calls holds a few of them."""

    def __init__(self, calls):
        self.calls, self.seen = calls, set()

    def append(self, item):
        shape = call_shape(*item)
        if shape not in self.seen:
            self.seen.add(shape)
            self.calls.append(item)


def _finite_tree(tree):
    if isinstance(tree, dict):
        return all(_finite_tree(v) for v in tree.values())
    return isinstance(tree, (int, float)) and math.isfinite(tree)


def learning_path(dev, stats):
    """The learning tools on the card: ``tools/mt_lift_experiment.py``'s sup
    and mt arms and ``tools/synthetic_convergence.py`` through their
    ``main``, every kernel call's first of each shape recorded and held
    against its plain version, the launches of each tool counted from 0."""
    import os
    import tempfile

    from mmt_psm_tpu_torch.engine import trainer as T
    from mmt_psm_tpu_torch.tools import mt_lift_experiment, synthetic_convergence

    loops, calls = [], []
    real_train = T.MTTrainer.train

    def counters():
        return {k: getattr(mod, attr) for k, (mod, attr, _) in kernel_wrappers().items()}

    def train(self, start_iter=0):
        before = {k: fn.launches for k, fn in counters().items()}
        t = time.perf_counter()
        out = real_train(self, start_iter)
        torch.cuda.synchronize()
        loops.append(dict(seconds=time.perf_counter() - t, iters=self.max_iter - start_iter,
                          mt=self.unlabeled_loader is not None,
                          launches={k: fn.launches - before[k] for k, fn in counters().items()}))
        return out

    runs = {}
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(T.MTTrainer, "train", train), \
            mock.patch.object(tempfile, "tempdir", tmp), recording(FirstOfEachShape(calls)):
        for name, run in (
                ("lift", lambda: mt_lift_experiment.main(LEARN_LIFT + ["--out", os.path.join(tmp, "lift.json")])),
                ("convergence", lambda: synthetic_convergence.main(
                    ["--iters", str(LEARN_CONVERGENCE_ITERS), "--out", os.path.join(tmp, "conv.json")]))):
            # each tool's launches: counts set to 0 just before it, read just after
            for fn in counters().values():
                fn.launches = 0
            t = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            runs[name] = dict(result=result, seconds=time.perf_counter() - t,
                              launches={k: fn.launches for k, fn in counters().items()})
    lift, conv = runs["lift"]["result"], runs["convergence"]["result"]
    if set(lift) != {"sup_student", "mt_student", "mt_teacher", "meta"} or set(lift["meta"]) != LIFT_META_KEYS or \
            any(set(lift[a]) != LIFT_ARM_KEYS or not _finite_tree(lift[a]) for a in lift if a != "meta"):
        raise AssertionError(f"the lift tool's JSON: {json.dumps(lift)}")
    if set(conv) != CONVERGENCE_KEYS or not _finite_tree({k: v for k, v in conv.items() if k != "card"}):
        raise AssertionError(f"the convergence tool's JSON: {json.dumps(conv)}")
    if [lp["mt"] for lp in loops] != [False, True] or any(lp["iters"] != 40 for lp in loops):
        raise AssertionError(f"the lift's loops: {loops}")
    for name, r in runs.items():
        if not all(r["launches"].values()):
            raise AssertionError(f"{name}: a kernel of the path never launched: {r['launches']}")
    timed, per_call = time_calls(calls)
    for k, (ms, plain_ms, b, err) in timed.items():
        stats[k].update(launches_learning=sum(r["launches"][k] for r in runs.values()), ms_learning=ms,
                        plain_ms_learning=plain_ms, bound_ms_learning=b["bound_ms"], bound_by_learning=b["bound_by"],
                        max_abs_err_learning=err)
    rates = {("mt" if lp["mt"] else "sup"): lp["iters"] / lp["seconds"] for lp in loops}
    arm_loops = [dict(lp, seconds=round(lp["seconds"], 3)) for lp in loops]
    print(f"learning bf16: the lift tool at 256 px ({' '.join(LEARN_LIFT)}) in {runs['lift']['seconds']:.3f} s, "
          f"launches {runs['lift']['launches']}; its loops {json.dumps(arm_loops)}; "
          f"synthetic_convergence --iters {LEARN_CONVERGENCE_ITERS} in {runs['convergence']['seconds']:.3f} s, "
          f"launches {runs['convergence']['launches']}", flush=True)
    print(f"learning iterations/s (batch 4 at 256 px, the loop over the tool's loaders): sup arm {rates['sup']:.3f}, "
          f"mt arm (20 supervised + 20 MT) {rates['mt']:.3f}; convergence {1 / conv['sec_per_iter']:.3f}", flush=True)
    print("learning results: " + json.dumps({"lift": lift, "convergence": conv}), flush=True)
    print("learning path's kernel calls, the first of each shape, each held against its plain version (kernel, "
          "shape, kernel ms, plain ms, max abs err, bound ms): " + json.dumps(per_call), flush=True)
    return rates


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = phase("card", card_line)
    print(card, flush=True)
    from mmt_psm_tpu_torch.ops import kernels

    phase("build kernels", kernels.build_all)
    stats = {}
    phase("K1 nms vs plain", lambda: check_nms(dev, stats))
    phase("K2 roi_align vs plain", lambda: check_roi_align(dev, stats))
    phase("K3 roi_align backward vs plain", lambda: check_roi_align_backward(dev, stats))
    patches_per_s = phase("flagship bf16", lambda: flagship(dev, stats))
    phase("flagship f32 vs plain", lambda: flagship_f32_vs_plain(dev))
    eval_timing, eval_ds = phase("eval bf16", lambda: eval_path(dev, stats))
    images_per_s = phase("train bf16", lambda: train_path(dev, stats))
    phase("train f32 vs plain", lambda: train_f32_vs_plain(dev))
    mt_images_per_s, mt_peak_gib = phase("mt bf16", lambda: mt_path(dev, stats))
    phase("mt f32 vs plain", lambda: mt_f32_vs_plain(dev))
    loop_images_per_s, steps_alone, loader_rates = phase(
        "train CLI bf16", lambda: train_cli_path(dev, stats, images_per_s, mt_images_per_s, eval_ds))
    variant_rates = phase("variants bf16", lambda: variants_path(dev, stats, eval_ds))
    phase("variants f32 vs plain", lambda: variants_f32_vs_plain(dev))
    coco_timing, datasets_train_rate, _ = phase("datasets bf16", lambda: datasets_path(dev, stats, eval_ds))
    dp_ranks = phase("data parallel", lambda: data_parallel_path(dev, stats))
    learning_rates = phase("learning bf16", lambda: learning_path(dev, stats))
    print(f"throughput: {patches_per_s:.3f} patches/s at {CANVAS}px, batch {BATCH}, bf16 on {card}", flush=True)
    print(f"eval throughput: {eval_timing['images_per_sec']} evaluated patches/s at {CANVAS}px, batch {BATCH}, bf16, "
          f"host paste and Papeval included, scored serially; stage_seconds "
          f"{json.dumps(eval_timing['stage_seconds'])} of {eval_timing['seconds']} s on {card}", flush=True)
    print(f"train throughput: {images_per_s:.3f} images/s at {CANVAS}px, batch {BATCH}, bf16 on {card}",
          flush=True)
    print(f"mt throughput: {mt_images_per_s:.3f} labeled images/s ({BATCH} labeled + {BATCH} unlabeled a step), "
          f"peak memory {mt_peak_gib:.3f} GiB at {CANVAS}px, bf16 on {card}", flush=True)
    print(f"train CLI throughput: {loop_images_per_s:.3f} labeled images/s in the loop's warm iterations at "
          f"{CANVAS}px, batch {BATCH}, bf16, against {steps_alone:.3f} for its steps alone; loaders at 1000-px "
          f"windows {json.dumps(loader_rates)} batches/s on {card}", flush=True)
    for name, row in variant_rates.items():
        print(f"variant {name} throughput: {row['patches_per_s']:.3f} patches/s, {row['images_per_s']:.3f} images/s "
              f"(supervised)" + (f", {row['evaluated_patches_per_s']:.3f} evaluated patches/s"
                                 if "evaluated_patches_per_s" in row else "")
              + (f", {row['mt_images_per_s']:.3f} MT labeled images/s" if "mt_images_per_s" in row else "")
              + f" at {CANVAS}px, batch {BATCH}, bf16 on {card}", flush=True)
    print(f"datasets throughput: {coco_timing['images_per_sec']} evaluated patches/s of the COCO sweep at {CANVAS}px, "
          f"batch {BATCH}, bf16, scored serially; stage_seconds {json.dumps(coco_timing['stage_seconds'])} of "
          f"{coco_timing['seconds']} s; train CLI {datasets_train_rate:.3f} images/s over {DATASETS_TRAIN_ITERS} "
          f"supervised iterations on {card}", flush=True)
    dp = [o["bf16"] for o in dp_ranks]
    rate = lambda kind: [round(DP_STEPS * b["images_per_rank"] / b[kind]["seconds"], 3) for b in dp]  # noqa: E731
    print(f"data parallel throughput: {DP_WORLD} ranks sharing one card over gloo, {dp[0]['images_per_rank']} labeled "
          f"images a rank and step: supervised {rate('sup')} labeled images/s a rank, MT {rate('mt')}; "
          f"gradient all-reduce {[round(b['allreduce']['ms'], 3) for b in dp]} ms for {dp[0]['allreduce']['elements']} "
          f"f32 elements, at {CANVAS}px, bf16 on {card}", flush=True)
    print(f"learning throughput: {json.dumps({k: round(v, 3) for k, v in learning_rates.items()})} iterations/s of "
          f"the lift tool's arms at 256 px, batch 4, bf16 on {card}", flush=True)
    print(json.dumps({"kernels": [stats["nms"], stats["roi_align"], stats["roi_align_backward"]]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
