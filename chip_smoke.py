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
  5. the flagship path (configs/pap/mmt_psm_r50_fpn.yaml, 1024 canvas,
     bf16, seeded random weights) on 3 batches of 4 images through
     ``build_model``; one forward runs with synchronising calls made
     errors (no host sync); launch counts show K1 and K2 ran on every
     forward;
     one batch also in f32 with the kernels and with the plain versions,
     TF32 off, whose detections must agree;
  6. a ``{"kernels": [...]}`` line with each kernel's time over its two
     calls of one flagship forward (K1: the RPN's and relation-NMS's; K2:
     the box head's and the mask head's), its plain version's time and its
     bound on this card, after a line with each call's own times;
  7. the throughput in patches/s beside the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
# bf16 comparison: the same f32 sum in another order, rounded once to bf16
BF16_RTOL, ATOL = 2.0**-7, 1e-5


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

    worst = 0.0
    for name, b, s, v, t in cases:
        got = N.nms_mask(b, s, v, t)
        want = N.nms_mask_plain(b, s, v, t)
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"K1 {name}: {bad} keep flags differ from the plain version")
        worst = max(worst, float((got.float() - want.float()).abs().max()))

    # time the kernel and its plain version on the flagship's two calls, the
    # RPN's and relation-NMS's, on score-sorted problems (flags only, no sort)
    per_call, nbytes, ops = {}, 0, 0.0
    for name, b, s, v, t in cases[:2]:
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
    stats["nms"] = dict(
        name="nms_suppress", route="cuda", source="mmt_psm_tpu_torch/csrc/nms.cu",
        replaces="mmt_psm_tpu/ops/nms_pallas.py:43", max_abs_err=worst,
        ms=sum(v[0] for v in per_call.values()), plain_ms=sum(v[1] for v in per_call.values()),
        **bound(nbytes, ops), library_ms=None,
    )
    print("K1 per call (kernel ms, plain ms): " + json.dumps(per_call), flush=True)


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
    # time the kernel and its plain version on the flagship's two calls, the
    # box head's and the mask head's, in bf16
    per_call, nbytes, ops = {}, 0, 0.0
    for name, (boxes, p) in timed.items():
        per_call[name] = (cuda_ms(lambda: Pm.multilevel_roi_align_cuda(feats16, boxes, scales, p, 2)),
                          cuda_ms(lambda: Pm.multilevel_roi_align_plain(feats16, boxes, scales, p, 2),
                                  iters=3, warmup=1))
        out_elems = boxes.shape[0] * boxes.shape[1] * p * p * 256
        # the cells the samples read, boxes and levels in, the pooled features out
        nbytes += sampled_cells(feats16, boxes, scales, p, 2) * 256 * 2 + boxes.numel() * 5 + out_elems * 2
        ops += out_elems * 4 * (4 * 2 + 2)  # 4 samples x (4 corner mul-adds + 2 row weights)
    stats["roi_align"] = dict(
        name="roi_align_forward", route="cuda", source="mmt_psm_tpu_torch/csrc/roi_align.cu",
        replaces="mmt_psm_tpu/ops/roi_align_pallas.py:92", max_abs_err=worst,
        ms=sum(v[0] for v in per_call.values()), plain_ms=sum(v[1] for v in per_call.values()),
        **bound(nbytes, ops), library_ms=None,
    )
    print("K2 per call (kernel ms, plain ms): " + json.dumps(per_call), flush=True)


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
    patches_per_s = phase("flagship bf16", lambda: flagship(dev, stats))
    phase("flagship f32 vs plain", lambda: flagship_f32_vs_plain(dev))
    print(f"throughput: {patches_per_s:.3f} patches/s at {CANVAS}px, batch {BATCH}, bf16 on {card}", flush=True)
    print(json.dumps({"kernels": [stats["nms"], stats["roi_align"]]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
