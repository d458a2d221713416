"""Inference engine: batched forwards on the model's device, then the
host's paste and Papeval (the port's copy of
``mmt_psm_tpu/engine/inference.py``, after the reference's
maskrcnn_benchmark/engine/inference.py:16-125 and
evaluation/pap/pap_eval.py:79-143).

The model emits 28x28 mask probabilities per detection; the host pastes
them into image space at threshold 0.5 (``engine/paste.py``) and scores
the box-cropped instance masks against the ground truth
(``evaluation/pap_eval.py``), in this process or in a pool of spawned
worker processes (``engine/_eval_worker.py``).

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

from ..data.loader import prefetch, usable_cpus
from ..data.transforms import PIXEL_MEAN_BGR
from ..evaluation import _native
from ..evaluation.pap_eval import PapEvaluator
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
    None). Two staging slots alternate: a slot's pinned input buffers are
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

    def _outputs(self, images, sizes):
        d = self.model(self.normalize(images, sizes), sizes)
        outs = [d.boxes, d.scores, d.labels, d.valid]
        if d.masks is not None:
            # the host pastes float16-rounded probabilities, as the JAX engine does
            outs.append(d.masks.to(torch.float16))
        return outs

    def dispatch(self, batch):
        images = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        sizes = torch.from_numpy(np.ascontiguousarray(batch["image_size"], np.int32))
        if not self.cuda:
            return [t.numpy() for t in self._outputs(images, sizes)]
        slot = self._slots[self._turn]
        self._turn = (self._turn + 1) % self.SLOTS
        if "copied" in slot and not slot["copied"].query():
            slot["copied"].synchronize()
        staged = []
        for key, src in (("image", images), ("sizes", sizes)):
            buf = slot.get(key)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = slot[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            staged.append(buf.to(self.device, non_blocking=True))
        slot["copied"] = torch.cuda.Event()
        slot["copied"].record()
        outs = self._outputs(*staged)
        host = slot.get("out")
        if host is None or [h.shape for h in host] != [o.shape for o in outs]:
            host = slot["out"] = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return done, host

    def fetch(self, pending):
        if not self.cuda:
            outs = pending
        else:
            done, host = pending
            done.synchronize()
            outs = [h.numpy().copy() for h in host]
        return (*outs[:4], outs[4] if len(outs) > 4 else None)


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
    mesh=None,
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
    ``mesh``, overlays (``visual_dir``) and ``.mat`` export (``mat_dir``)
    are not ported yet and raise.
    """
    if mesh is not None or (torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1):
        raise NotImplementedError("sharded evaluation and its gather across processes are not ported yet "
                                  "(ROADMAP item 19)")
    if (visual_dir and visual_num) or mat_dir:
        raise NotImplementedError("prediction overlays and .mat export are not ported yet (ROADMAP item 20)")
    stage = DeviceStage(model)
    if eval_workers < 0:
        ncpu = usable_cpus()
        eval_workers = max(ncpu - 1, 0) if ncpu > 2 else 0
    evaluator = PapEvaluator(categories=categories, max_dets=max_dets)
    t0, t0_wall = time.perf_counter(), time.time()
    pool, pings = _start_pool(eval_workers) if eval_workers > 0 else (None, [])
    # per image in order, a worker's Future: the accumulation order, and so
    # the ties of the mergesort PR curves, do not depend on the workers
    result_slots = []
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
            boxes, scores, labels, valid, masks16 = stage.fetch(pending)
            acc["device"] += time.perf_counter() - t_d
            if masks16 is None:
                # a box-only model: box-filled 1x1 probabilities
                masks = np.ones(boxes.shape[:2] + (1, 1), np.float32)
            else:
                # widened once here; workers get the float16 copy and widen it
                masks = masks16.astype(np.float32)
            # the test loader pads the last batch by repeating a sample
            n_real = int(batch.get("n_real", boxes.shape[0]))
            for i in range(n_real):
                t_g = time.perf_counter()
                gt = gt_to_instseg(np.asarray(batch["boxes"][i]), np.asarray(batch["labels"][i]),
                                   np.asarray(batch["gt_valid"][i]), np.asarray(batch["masks"][i]))
                t_s = time.perf_counter()
                acc["gt"] += t_s - t_g
                hw = tuple(np.asarray(batch["image_size"][i]).tolist())
                if pool is not None:
                    result_slots.append(pool.submit(_eval_worker.eval_one, (
                        boxes[i], scores[i], labels[i], valid[i], masks[i] if masks16 is None else masks16[i],
                        hw, gt, evaluator.categories, evaluator.max_dets, evaluator.use_iou)))
                else:
                    evaluator.add_image(detections_to_instseg(boxes[i], scores[i], labels[i], valid[i], masks[i], hw),
                                        gt)
                acc["score"] += time.perf_counter() - t_s
                n_images += 1
            batch, pending = next_batch, next_pending
        if pool is not None:
            t = time.perf_counter()
            for slot in result_slots:
                evaluator.results.extend(slot.result())
            acc["score"] += time.perf_counter() - t
            pool_start = max(p.result() for p in pings) - t0_wall
    finally:
        # stop the prefetch thread and the workers even if scoring raised
        close = getattr(batches, "close", None)
        if close is not None:
            close()
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    seconds = time.perf_counter() - t0
    stats = evaluator.summarize()
    return stats, {
        "images": n_images,
        "seconds": seconds,
        "images_per_sec": n_images / max(seconds, 1e-9),
        "stage_seconds": acc,
        "pool_start_seconds": pool_start if pool is not None else None,
    }
