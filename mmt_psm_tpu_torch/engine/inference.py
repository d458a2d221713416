"""Inference engine: batched forwards on the model's device, then the
host's paste and Papeval (the port's copy of
``mmt_psm_tpu/engine/inference.py``, after the reference's
maskrcnn_benchmark/engine/inference.py:16-125 and
evaluation/pap/pap_eval.py:79-143).

The model emits 28x28 mask probabilities per detection (a box-only model
none: each box is then filled); a model with set-NMS (K_HEAD > 1) tags its
detections with their proposals, and the host keeps the set-NMS survivors
of each class (``models/box_head.py::set_nms_filter``). The host pastes
the masks into image space at threshold 0.5 (``engine/paste.py``) and scores
the box-cropped instance masks against the ground truth
(``evaluation/pap_eval.py``), in this process or in a pool of spawned
worker processes (``engine/_eval_worker.py``). An image whose overlay or
``.mat`` label map is written (``utils/visual.py``, ``utils/mat_output.py``)
is pasted and scored in this process.

In a process group of W ranks (``parallel/comm.py``) the evaluation is
sharded: each rank serves its ``data.samplers.ShardSampler`` share of the
test windows (``make_test_loader(indices=...)``, whose batches carry each
row's dataset index and leave the sampler's padding repeats unscored), the
ranks' per-image Papeval rows are gathered and put back in dataset order,
and every rank returns the stats of the whole split: those of one process
that served every window.

``DeviceStage`` runs the forwards. On the card it copies each batch's
canvases (raw RGB uint8 from ``make_test_loader(raw_u8=True)``) through
one of two pinned staging buffers with
``non_blocking=True``, flips BGR, subtracts the pixel mean and zeroes the
canvas outside each image on the card, runs ``model(images, sizes)``,
casts the mask probabilities to float16 and copies the outputs into
pinned host buffers behind a CUDA event. ``run_inference`` launches batch
i + 1 before it waits on batch i's event, so the card computes one batch
while the host scores the one before.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from ..data.loader import prefetch, usable_cpus
from ..data.transforms import PIXEL_MEAN_BGR
from ..evaluation import _native
from ..evaluation.pap_eval import PapEvaluator
from ..models.box_head import set_nms_filter
from ..parallel import comm
from ..utils.mat_output import save_mat_output
from ..utils.visual import overlay_instances
from . import _eval_worker
from .paste import detections_to_instseg, gt_to_instseg

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_expected_results(stats: dict, expected_results, sigma_tol: float = 4):
    """Statistical regression check (reference TEST.EXPECTED_RESULTS,
    config/defaults.py:397-398): each entry is ``(metric, mean, std)`` with
    ``metric`` a ``/``-joined path into the stats dict (e.g. "AJI/2" or
    "mAP/all"). Returns a list of (metric, actual, lo, hi, ok); raises
    AssertionError if any fail."""
    report = []
    failed = []
    for metric, mean, std in expected_results:
        node = stats
        for part in str(metric).split("/"):
            key = part
            if isinstance(node, dict) and key not in node:
                try:
                    key = int(part)
                except ValueError:
                    pass
            node = node[key]
        actual = float(node)
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        ok = lo <= actual <= hi
        report.append((metric, actual, lo, hi, ok))
        if not ok:
            failed.append(f"{metric}: {actual:.4f} outside [{lo:.4f}, {hi:.4f}]")
    if failed:
        raise AssertionError("; ".join(failed))
    return report


class DeviceStage:
    """Runs the model's forwards on the device of its parameters.

    ``dispatch(batch)`` launches one batch and returns at once on the card
    (on the CPU it runs the forward); ``fetch(pending)`` waits for it and
    returns numpy copies of (boxes, scores, labels, valid, masks float16 or
    None for a box-only model, head_ids or None where the model does not
    tag its detections for set-NMS). Two staging slots alternate: a slot's pinned input buffers are
    written again only after the event of their last copy to the card, and
    its pinned output buffers only after ``fetch`` has copied them out."""

    SLOTS = 2

    def __init__(self, model):
        self.model = model
        self.device = next(model.parameters()).device
        self.cuda = self.device.type == "cuda"
        self.mean = torch.from_numpy(PIXEL_MEAN_BGR).to(self.device)
        self._slots = [{} for _ in range(self.SLOTS)]
        self._turn = 0

    def normalize(self, images: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        """Raw RGB uint8 canvases -> BGR float32 minus the pixel mean, 0
        outside each image (as the host's normalize-then-pad gives)."""
        if images.dtype != torch.uint8:
            raise TypeError(f"the device stage takes raw uint8 canvases (make_test_loader(raw_u8=True)), "
                            f"not {images.dtype}")
        x = images.flip(-1).float() - self.mean
        h, w = images.shape[1:3]
        ys = torch.arange(h, device=images.device)[None, :, None]
        xs = torch.arange(w, device=images.device)[None, None, :]
        inside = (ys < sizes[:, 0, None, None]) & (xs < sizes[:, 1, None, None])
        return torch.where(inside[..., None], x, torch.zeros((), device=images.device))

    def _forward(self, images, sizes):
        with record_function("device_stage_normalize"):
            images = self.normalize(images, sizes)
        return self.model(images, sizes)

    def dispatch(self, batch):
        if not self.cuda:
            d = self._forward(*_host_tensors(batch))
            return {k: None if t is None else t.numpy() for k, t in _outputs(d).items()}
        slot = self._slots[self._turn]
        self._turn = (self._turn + 1) % self.SLOTS
        # the record_function labels name the phases in a torch.profiler trace
        # (perfbench's host_ms and wait_ms metrics read them)
        with record_function("device_stage_slot_wait"):
            if "copied" in slot and not slot["copied"].query():
                slot["copied"].synchronize()
        with record_function("device_stage_staging"):
            pinned = []
            for key, src in zip(("image", "sizes"), _host_tensors(batch)):
                buf = slot.get(key)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = slot[key] = _pinned_empty(src.shape, src.dtype)
                buf.copy_(src)
                pinned.append(buf)
        with record_function("device_stage_upload"):
            staged = [buf.to(self.device, non_blocking=True) for buf in pinned]
            slot["copied"] = torch.cuda.Event()
            slot["copied"].record()
        d = self._forward(*staged)
        with record_function("device_stage_copy_out"):
            outs = {k: t for k, t in _outputs(d).items() if t is not None}
            host = slot.get("out")
            if host is None or {k: h.shape for k, h in host.items()} != {k: o.shape for k, o in outs.items()}:
                host = slot["out"] = {k: _pinned_empty(o.shape, o.dtype) for k, o in outs.items()}
            for k, o in outs.items():
                host[k].copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return done, host

    def fetch(self, pending):
        if not self.cuda:
            outs = pending
        else:
            done, host = pending
            with record_function("device_stage_fetch_wait"):
                done.synchronize()
            with record_function("device_stage_fetch_copy"):
                outs = {k: h.numpy().copy() for k, h in host.items()}
        return tuple(outs.get(k) for k in ("boxes", "scores", "labels", "valid", "masks", "head_ids"))


def _host_tensors(batch):
    """The batch's canvases and sizes as host tensors, no copy where they are contiguous."""
    return (torch.from_numpy(np.ascontiguousarray(batch["image"])),
            torch.from_numpy(np.ascontiguousarray(batch["image_size"], np.int32)))


def _pinned_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _outputs(d) -> dict:
    # the host pastes float16-rounded probabilities, as the JAX engine does
    return {"boxes": d.boxes, "scores": d.scores, "labels": d.labels, "valid": d.valid,
            "masks": None if d.masks is None else d.masks.to(torch.float16), "head_ids": d.head_ids}


def _start_pool(workers: int):
    """``workers`` spawned processes (never forked: this process may hold a
    CUDA context), each started now and its C++ library loaded, so they
    boot while the first batches run. The library is built here first, so
    the workers load one build instead of each compiling its own. Only
    PYTHONPATH is set for them. Returns the pool and the futures of its
    start-up pings, each the wall-clock time its worker answered."""
    _native.library()
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, saved) if p)
    try:
        pool = ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn"))
        # each submit starts one more process
        pings = [pool.submit(_eval_worker.ping) for _ in range(workers)]
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved
    return pool, pings


def run_inference(
    model,
    batches,
    categories=(1, 2),
    max_dets: int = 200,
    visual_num: int = 0,
    visual_dir: str | None = None,
    mat_dir: str | None = None,
    eval_workers: int = 0,
    prefetch_depth: int = -1,
):
    """Evaluate ``model`` over ``batches`` on the device of its parameters.

    batches: iterable of test-loader dicts (image, image_size, gt boxes,
    labels, gt_valid, masks, n_real) with raw uint8 canvases. Returns
    (stats, timing): Papeval's stats dict, and {"images", "seconds",
    "images_per_sec", "stage_seconds", "pool_start_seconds"} with the
    host's seconds in each stage: ``loader`` (waiting for the next batch),
    ``device`` (launching a forward and waiting for its outputs), ``gt``
    (gt conversion) and ``score`` (paste and Papeval, or handing the image
    to a worker and waiting for its rows); ``pool_start_seconds`` is the
    time from the start until the last worker answered its start-up ping
    (overlapping the stages), None when scoring is serial.

    eval_workers: > 0 pastes and scores images in that many spawned
    processes (gt conversion stays here, so full-frame gt masks never
    cross a pipe); rows are added in image order whatever order the
    workers finish in. -1: one per spare core, serial without spare cores.
    prefetch_depth: batches assembled ahead in a thread (``data.loader.
    prefetch``); 0 synchronous, -1 auto.
    visual_num, visual_dir: the overlays of the images ``n`` < ``visual_num``
    as ``visual_dir/vis_<n:04d>.png`` (TEST.VISUAL_NUM, the reference's
    pap_eval.py:49-77), drawn over the raw uint8 window; ``n`` is the
    image's place in the split: its dataset index where batches carry
    ``index``, so ranks that share one directory write each file once.
    mat_dir: every image's instance label map as
    ``mat_dir/img_<n:04d>.mat`` (TEST.GEN, the reference's ISBI export,
    tools/test_net.py:109-121).
    In a process group of more than one rank every batch must carry
    ``index`` (``make_test_loader(indices=ShardSampler(...))``) and the
    stats are the whole split's, the same on every rank; "images" counts
    this rank's. JAX's ``mesh`` argument has no counterpart: the loader's
    indices say which windows a rank serves.
    """
    sharded = comm.get_world_size() > 1
    stage = DeviceStage(model)
    if eval_workers < 0:
        ncpu = usable_cpus()
        eval_workers = max(ncpu - 1, 0) if ncpu > 2 else 0
    evaluator = PapEvaluator(categories=categories, max_dets=max_dets)
    t0, t0_wall = time.perf_counter(), time.time()
    pool, pings = _start_pool(eval_workers) if eval_workers > 0 else (None, [])
    # per image in order, a worker's Future or the rows scored here: the
    # accumulation order, and so the ties of the mergesort PR curves, do not
    # depend on the workers (nor, sharded, on the ranks: each image's rows
    # go with its dataset index)
    result_slots, image_index = [], []
    n_images = 0
    acc = {"loader": 0.0, "device": 0.0, "gt": 0.0, "score": 0.0}
    if prefetch_depth != 0:
        batches = prefetch(batches, prefetch_depth)
    try:
        it = iter(batches)
        t = time.perf_counter()
        batch = next(it, None)
        acc["loader"] += time.perf_counter() - t
        t = time.perf_counter()
        pending = stage.dispatch(batch) if batch is not None else None
        acc["device"] += time.perf_counter() - t
        while batch is not None:
            t = time.perf_counter()
            next_batch = next(it, None)
            t_d = time.perf_counter()
            acc["loader"] += t_d - t
            next_pending = stage.dispatch(next_batch) if next_batch is not None else None
            boxes, scores, labels, valid, masks16, head_ids = stage.fetch(pending)
            acc["device"] += time.perf_counter() - t_d
            if masks16 is None:
                # a box-only model: box-filled 1x1 probabilities
                masks = np.ones(boxes.shape[:2] + (1, 1), np.float32)
            else:
                # widened once here; workers get the float16 copy and widen it
                masks = masks16.astype(np.float32)
            # the test loader pads the last batch by repeating a sample
            n_real = int(batch.get("n_real", boxes.shape[0]))
            if sharded and "index" not in batch:
                raise ValueError("a sharded evaluation needs each row's dataset index: build the loader with "
                                 "make_test_loader(indices=ShardSampler(...))")
            for i in range(n_real):
                v_i = valid[i]
                if head_ids is not None:
                    # K_HEAD > 1: set-NMS on the host (box_head/inference.py:120-122)
                    v_i = set_nms_filter(boxes[i], scores[i], labels[i], v_i, head_ids[i],
                                         nms_thresh=model.config.nms_thresh,
                                         num_classes=model.config.num_classes)
                t_g = time.perf_counter()
                gt = gt_to_instseg(np.asarray(batch["boxes"][i]), np.asarray(batch["labels"][i]),
                                   np.asarray(batch["gt_valid"][i]), np.asarray(batch["masks"][i]))
                t_s = time.perf_counter()
                acc["gt"] += t_s - t_g
                hw = tuple(np.asarray(batch["image_size"][i]).tolist())
                name = int(batch["index"][i]) if "index" in batch else n_images
                visual = bool(visual_dir) and name < visual_num
                if pool is not None and not (visual or mat_dir):
                    result_slots.append(pool.submit(_eval_worker.eval_one, (
                        boxes[i], scores[i], labels[i], v_i, masks[i] if masks16 is None else masks16[i],
                        hw, gt, evaluator.categories, evaluator.max_dets, evaluator.use_iou)))
                else:
                    dt = detections_to_instseg(boxes[i], scores[i], labels[i], v_i, masks[i], hw)
                    if visual:
                        from PIL import Image

                        # the raw uint8 RGB window of the device stage's loader
                        os.makedirs(visual_dir, exist_ok=True)
                        Image.fromarray(overlay_instances(np.asarray(batch["image"][i][: hw[0], : hw[1]]),
                                                          {"masks": dt})).save(
                            os.path.join(visual_dir, f"vis_{name:04d}.png"))
                    if mat_dir:
                        save_mat_output(dt, hw[0], hw[1], os.path.join(mat_dir, f"img_{name:04d}.mat"))
                    before = len(evaluator.results)
                    evaluator.add_image(dt, gt)
                    if pool is not None or sharded:
                        result_slots.append(evaluator.results[before:])
                        del evaluator.results[before:]
                if sharded:
                    image_index.append(name)
                acc["score"] += time.perf_counter() - t_s
                n_images += 1
            batch, pending = next_batch, next_pending
        t = time.perf_counter()
        rows = [slot if isinstance(slot, list) else slot.result() for slot in result_slots]
        acc["score"] += time.perf_counter() - t
        if pool is not None:
            pool_start = max(p.result() for p in pings) - t0_wall
    finally:
        # stop the prefetch thread and the workers even if scoring raised
        close = getattr(batches, "close", None)
        if close is not None:
            close()
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    if sharded:
        # every rank's (dataset index, rows) of each image, in dataset order
        # (the sampler's padding repeats are not scored: ``n_real``)
        merged = {idx: r for part in comm.all_gather(list(zip(image_index, rows))) for idx, r in part}
        rows = [merged[i] for i in sorted(merged)]
    for r in rows:
        evaluator.results.extend(r)
    seconds = time.perf_counter() - t0
    stats = evaluator.summarize()
    return stats, {
        "images": n_images,
        "seconds": seconds,
        "images_per_sec": n_images / max(seconds, 1e-9),
        "stage_seconds": acc,
        "pool_start_seconds": pool_start if pool is not None else None,
    }
