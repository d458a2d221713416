"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero and no result
line is printed):
  1. require CUDA and print the card's name and power limit;
  2. build the CUDA kernels from ``mmt_psm_tpu_torch/csrc``;
  3. kernel K1 (greedy NMS) against its plain version on the card, at the
     flagship's shapes and on adversarial cases: identical keep masks;
  4. kernel K2 (multi-level ROIAlign) against its plain version on the
     card at the box-head and mask-head shapes, f32 and bf16, with RoIs
     far larger than the TPU kernel's window;
  5. kernel K3 (multi-level ROIAlign backward) against its plain version
     on the card at the train step's box-head and mask-head shapes, f32
     and bf16, with oversize, border and clustered RoIs whose atomic adds
     collide;
  6. the flagship path (configs/pap/mmt_psm_r50_fpn.yaml, 1024 canvas,
     bf16, seeded random weights) on 3 batches of 4 images through
     ``build_model``; one forward runs with synchronising calls made
     errors (no host sync); launch counts show K1 and K2 ran on every
     forward;
     one batch also in f32 with the kernels and with the plain versions,
     TF32 off, whose detections must agree;
  7. the supervised train step (``build_trainer``, same config, bf16,
     batch 4 of synthetic cells): 2 warm-up steps, one step with
     synchronising calls made errors, then 5 timed steps, in which K1
     launches once per step and K2 and K3 twice; every loss finite, the
     trainable parameters moved, the stem, layer1 and every FrozenBN tensor
     bit-unchanged;
  8. one f32 train step with the kernels, against the same step with the
     plain versions of all three and with K3's alone, TF32 off (the
     relation head's geometric gate kept off its pole, as in
     tests/test_torch_port_train_step.py): losses and every gradient agree;
  9. a ``{"kernels": [...]}`` line with each kernel's time over its calls
     of one flagship forward (K1: the RPN's and relation-NMS's; K2: the box
     head's and the mask head's) or of one train step (K3: the box head's
     and the mask head's), its plain version's time and its bound on this
     card, the K1 and K2 numbers of the train step under ``*_train`` keys,
     after lines with each call's own times;
 10. the throughput in patches/s and images/s beside the card's name and
     power limit.
The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# (non-tensor-core) operations/s. Bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BATCH, BATCHES, CANVAS = 4, 3, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# bf16 comparison: the same f32 sum in another order, rounded once to bf16
BF16_RTOL, ATOL = 2.0**-7, 1e-5
# K3 f32: sums of up to a few hundred weighted cotangents per cell, in atomic order
K3_F32_ATOL = 1e-4
# the f32 train step with the kernels against the plain versions: the same
# arithmetic with float32 sums in other orders (K3's atomics among them).
# The relation head's geometric gate log(max(relu(WG(pos)), 1e-6)) has a
# pole: a gate within float32 noise of 0 takes a gradient of up to 1e6, so
# the comparison sets WG's bias to WG_BIAS in both models and every gate
# sits near it. Each gradient is held by its L2 norm, ||g - g'|| <=
# rtol ||g'|| + 1e-6. With all three kernels swapped, GRAD_RTOL: where K2's
# float32 rounding puts a ReLU input of the box head on the other side of
# 0, one unit flips for one RoI, and that RoI's changed cotangent reaches
# every backbone gradient through K3. With K3 alone swapped the forward is
# the same, and only the order of K3's atomic float32 adds differs:
# K3_GRAD_RTOL.
LOSS_RTOL, GRAD_RTOL, K3_GRAD_RTOL, WG_BIAS = 1e-4, 1e-2, 1e-4, 5.0


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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_boxes(gen, b, n, canvas, dev):
    """Boxes of 8..600 px in the canvas, a tenth of them oversize or
    elongated (spanning well over 48 cells of their level) or hanging
    over the border."""
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    wh = 8 + 592 * u(b, n, 2) ** 2
    xy = u(b, n, 2) * (canvas - wh)
    boxes = torch.cat([xy, xy + wh], -1)
    k = max(n // 10, 4)
    big = torch.tensor([[-100.0, -80.0, 1200.0, 1150.0], [0.0, 500.0, 1023.0, 530.0],
                        [300.0, 0.0, 330.0, 1023.0], [-50.0, 900.0, 150.0, 1100.0]], device=dev)
    boxes[:, :k] = big.repeat(k // 4 + 1, 1)[:k]
    return boxes


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
        per_call[name] = (cuda_ms(lambda: N.suppress_cuda(bs, vs, th)),
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
        per_call[name] = (cuda_ms(lambda: Pm.multilevel_roi_align_cuda(feats, boxes, scales, p, 2)),
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
    K3's atomic adds into the same gradient cells collide."""
    centres = random_boxes(gen, b, n // 16 + 1, CANVAS, dev)
    boxes = centres.repeat_interleave(16, dim=1)[:, :n]
    return boxes + 2.0 * torch.rand(b, n, 4, generator=gen, device=dev)


def check_roi_align_backward(dev, stats):
    from mmt_psm_tpu_torch.ops import pooler as Pm

    gen = torch.Generator(device=dev).manual_seed(5)
    scales = (0.25, 0.125, 0.0625, 0.03125)
    shapes = [(BATCH, CANVAS // 4 >> i, CANVAS // 4 >> i, 256) for i in range(4)]
    worst, per_call, nbytes, ops = 0.0, {}, 0, 0.0
    # the train step's two calls: 512 sampled RoIs per image at P = 7, 128 mask RoIs at P = 14
    for name, n, p in (("box_head", 512, 7), ("mask_head", 128, 14)):
        boxes = torch.cat([random_boxes(gen, BATCH, n // 2, CANVAS, dev), cluster_boxes(gen, BATCH, n - n // 2, dev)], 1)
        g32 = torch.randn(BATCH, n, p, p, 256, generator=gen, device=dev)
        for g in (g32, g32.to(torch.bfloat16)):
            got = Pm.multilevel_roi_align_backward_cuda(g, boxes, shapes, scales, p, 2)
            want = Pm.multilevel_roi_align_backward_plain(g, boxes, shapes, scales, p, 2)
            for lv, (a, b) in enumerate(zip(got, want)):
                if a.dtype != g.dtype or a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"K3 {name} level {lv}: {a.dtype} {tuple(a.shape)} or non-finite")
                err = float((a.float() - b.float()).abs().max())
                ref = float(b.float().abs().max())
                # f32: the same sums as the plain index_add_, in another (atomic) order;
                # bf16: that f32 sum rounded once, so one bf16 rounding step at most
                ok = err <= K3_F32_ATOL if g.dtype == torch.float32 else err <= BF16_RTOL * ref
                if not ok:
                    raise AssertionError(f"K3 {name} {g.dtype} level {lv}: max err {err} (max |ref| {ref})")
                if g.dtype == torch.float32:
                    worst = max(worst, err)
        g16 = g32.to(torch.bfloat16)
        per_call[name] = (cuda_ms(lambda: Pm.multilevel_roi_align_backward_cuda(g16, boxes, shapes, scales, p, 2)),
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


def flagship_f32_vs_plain(dev):
    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(device=dev, seed=0, opts=["TPU.COMPUTE_DTYPE", "float32"])
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
    still = [n for n, p0 in trainable.items() if torch.equal(params[n].detach(), p0)]
    # a weight decays even where its gradient is 0; a bias moves where its gradient is not
    if [n for n in still if not n.endswith(".bias")] or len(still) > len(trainable) // 20:
        raise AssertionError(f"trainable tensors that did not move: {still}")
    print(f"train bf16: {TRAIN_STEPS} steps of {BATCH} at {CANVAS}px after {TRAIN_WARMUP + 1} warm-up, "
          f"losses of the last step {json.dumps({k: v[-1] for k, v in losses.items()})}, "
          f"{len(trainable) - len(still)}/{len(trainable)} trainable tensors moved, {len(frozen)} frozen "
          f"bit-unchanged, launches {launches}", flush=True)
    return TRAIN_STEPS * BATCH / wall


def train_f32_vs_plain(dev):
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm
    from mmt_psm_tpu_torch.train import build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = batch_to_torch(generate_batch(7, 2, image_size=CANVAS, max_instances=64), dev)

    def step(swap):
        trainer = build_trainer(device=dev, seed=0, opts=["TPU.COMPUTE_DTYPE", "float32"])
        with torch.no_grad():  # keep the relation head's geometric gate off its pole (see GRAD_RTOL)
            trainer.model.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
        plain = {"nms": (N, "suppress_cuda", N.suppress_plain),
                 "roi_align": (Pm, "multilevel_roi_align_cuda", Pm.multilevel_roi_align_plain),
                 "roi_align_backward": (Pm, "multilevel_roi_align_backward_cuda",
                                        Pm.multilevel_roi_align_backward_plain)}
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
        if set(got_g) != set(want_g):
            raise AssertionError("f32 train step: the kernels and the plain versions differentiate other tensors")
        diff = {n: float(torch.linalg.vector_norm(got_g[n] - w)) for n, w in want_g.items()}
        norm = {n: float(torch.linalg.vector_norm(w)) for n, w in want_g.items()}
        l2 = {n: diff[n] / max(norm[n], 1e-30) for n in diff}
        peak = {n: float((got_g[n] - w).abs().max() / w.abs().max().clamp(min=1e-30)) for n, w in want_g.items()}
        # 1e-6 absolute for gradients that are 0 but for rounding (WK's bias: a softmax ignores a shift)
        over = {n: (diff[n], norm[n]) for n in diff if not diff[n] <= rtol * norm[n] + 1e-6}
        if over:
            raise AssertionError(f"f32 train step, {swap} plain: gradients differ beyond {rtol} of their norm: {over}")
        worst = lambda d: sorted(((v, n) for n, v in d.items()), reverse=True)[:3]  # noqa: E731
        lines.append(f"{'+'.join(swap)} plain: losses within {LOSS_RTOL} relative (max "
                     f"{max(abs(got_l[k] - want_l[k]) / abs(want_l[k]) for k in want_l):.3g}), {len(l2)} gradients "
                     f"within {rtol} of their norm + 1e-6; worst |diff|/|grad| {worst(l2)}, worst max|diff|/max|grad| "
                     f"{worst(peak)}")
    torch.backends.cudnn.allow_tf32 = True
    print("train f32 kernels vs " + "; ".join(lines), flush=True)


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
    images_per_s = phase("train bf16", lambda: train_path(dev, stats))
    phase("train f32 vs plain", lambda: train_f32_vs_plain(dev))
    print(f"throughput: {patches_per_s:.3f} patches/s at {CANVAS}px, batch {BATCH}, bf16 on {card}", flush=True)
    print(f"train throughput: {images_per_s:.3f} images/s at {CANVAS}px, batch {BATCH}, bf16 on {card}",
          flush=True)
    print(json.dumps({"kernels": [stats["nms"], stats["roi_align"], stats["roi_align_backward"]]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
