"""Batch assembly on the host (the port's copy of
``mmt_psm_tpu/data/loader.py``, after the
reference's DataLoader and collators, maskrcnn_benchmark/data/build.py:
143-318 and collate_batch.py:5-76).

Every batch is fixed-shape numpy: each image top-left on a square canvas,
gt padded to MAX_GT rows.

* ``make_source_loader``: endless labeled training batches through
  ``source_transform``, a fresh permutation of the dataset each pass, full
  batches only (the reference's IterationBasedBatchSampler cycling);
* ``make_unlabeled_loader``: endless mean-teacher batches of one shared
  geometric transform a patch and AUG_K teacher + AUG_S student colour
  views (BatchCollatorWoLabelK, collate_batch.py:58-76);
* ``make_test_loader``: one pass, masks ragged (only the host reads them),
  the last batch padded by repeating its last sample with ``n_real``
  counting the real ones;
* ``make_tta_loader``: one pass of test-time-augmentation batches, K
  colour views a sample under ``tta_views`` (TTABatchCollator).

``prefetch`` assembles batches ahead in a background thread.
"""

from __future__ import annotations

import numpy as np

from . import transforms as T


def pad_to_canvas(sample: dict, canvas: int, max_gt: int, mask_size: int | None = None, pad_masks: bool = True) -> dict:
    """Place the (resized) image top-left on a [canvas, canvas] frame and
    pad GT arrays to fixed sizes.

    pad_masks=False keeps the instance masks as the ragged resized array
    (host-side eval only reads them per image; padding 64 canvas-sized
    planes per image costs ~70MB/image of pure memset)."""
    img = sample["image"]
    h, w = img.shape[:2]
    assert h <= canvas and w <= canvas, (h, w, canvas)
    # raw-u8 pipelines (device-side normalization) keep the canvas u8 —
    # 4x less host->device traffic; normalized pipelines stay f32
    dtype = np.uint8 if img.dtype == np.uint8 else np.float32
    out_img = np.zeros((canvas, canvas, 3), dtype)
    out_img[:h, :w] = img

    mask_size = mask_size or canvas
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    n = min(len(sample.get("boxes", [])), max_gt)
    if pad_masks:
        masks = np.zeros((max_gt, mask_size, mask_size), np.uint8)
    else:
        masks = np.asarray(sample.get("masks", np.zeros((0, h, w))), np.uint8)[:n]
    if n:
        boxes[:n] = sample["boxes"][:n]
        labels[:n] = sample["labels"][:n]
        valid[:n] = True
        if pad_masks:
            src = sample["masks"][:n]
            if mask_size == canvas:
                masks[:n, :h, :w] = src[:, :h, :w]
            else:
                step = canvas // mask_size
                for i in range(n):
                    m = np.zeros((canvas, canvas), np.uint8)
                    m[:h, :w] = src[i][:h, :w]
                    masks[i] = m[::step, ::step][:mask_size, :mask_size]
    return {
        "image": out_img,
        "boxes": boxes,
        "labels": labels,
        "gt_valid": valid,
        "masks": masks,
        "image_size": np.array([h, w], np.int32),
    }


def _stack(batch_list):
    out = {}
    for k in batch_list[0]:
        vals = [b[k] for b in batch_list]
        shapes = {np.shape(v) for v in vals}
        # ragged entries (unpadded eval masks) stay a python list
        out[k] = np.stack(vals) if len(shapes) == 1 else vals
    return out


def make_source_loader(
    dataset,
    batch_size: int,
    canvas: int,
    max_gt: int = 64,
    mask_size: int | None = None,
    min_size: int = 800,
    max_size: int = 1333,
    seed: int = 0,
    num_iterations: int | None = None,
    shuffle: bool = True,
):
    """Endless (or ``num_iterations``) labeled training batches:
    ``image`` f32 [B, canvas, canvas, 3] normalized BGR, ``boxes``,
    ``labels``, ``gt_valid``, ``masks`` u8 [B, MAX_GT, m, m] and
    ``image_size``; every draw from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)

    def gen():
        it = 0
        while num_iterations is None or it < num_iterations:
            order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                samples = []
                for idx in order[start : start + batch_size]:
                    s = T.source_transform(dataset[int(idx)], rng, min_size, max_size)
                    samples.append(pad_to_canvas(s, canvas, max_gt, mask_size))
                yield _stack(samples)
                it += 1
                if num_iterations is not None and it >= num_iterations:
                    return

    return gen()


def make_unlabeled_loader(
    dataset,
    batch_size: int,
    canvas: int,
    aug_k: int = 2,
    aug_s: int = 1,
    min_size: int = 800,
    max_size: int = 1333,
    seed: int = 1,
):
    """Endless unlabeled batches: ``t_images`` f32 [B, AUG_K, canvas,
    canvas, 3] (the teacher's views), ``s_images`` [B, AUG_S, ...] (the
    student's), normalized BGR, and ``image_size`` [B, 2]."""
    rng = np.random.default_rng(seed)
    k_total = aug_k + aug_s

    def gen():
        while True:
            order = rng.permutation(len(dataset))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                t_views, s_views, sizes = [], [], []
                for idx in order[start : start + batch_size]:
                    views = T.unlabeled_transform({"image": dataset[int(idx)]}, rng, k_total, min_size, max_size)
                    h, w = views[0].shape[:2]
                    padded = np.zeros((k_total, canvas, canvas, 3), np.float32)
                    for c, v in zip(padded, views):
                        c[:h, :w] = v
                    t_views.append(padded[:aug_k])
                    s_views.append(padded[aug_k:])
                    sizes.append([h, w])
                yield {"t_images": np.stack(t_views), "s_images": np.stack(s_views),
                       "image_size": np.asarray(sizes, np.int32)}

    return gen()


def make_test_loader(
    dataset,
    batch_size: int,
    canvas: int,
    max_gt: int = 64,
    mask_size: int | None = None,
    min_size: int = 800,
    max_size: int = 1333,
    raw_u8: bool = False,
    indices=None,
):
    """Single-pass eval iterator (pads the final partial batch by
    repeating the last sample; consumers filter via n_real).

    indices: the dataset indices to serve, in order (a rank's
    ``data.samplers.ShardSampler``); each batch then carries its rows'
    indices as ``index`` (int64), which the sharded evaluation merges by.
    A shard's padding repeats (its last ``len - num_real`` indices) are
    served but left out of ``n_real``, so no image is scored twice.
    Default: the whole dataset in order, without ``index``.

    raw_u8=True ships resized RGB uint8 canvases and leaves the BGR flip
    and the mean subtraction to the device (``engine/inference.py``'s
    device stage): a quarter of the f32 bytes to copy. Valid only with
    PIXEL_STD 1, as the device subtracts the mean only."""
    order = list(range(len(dataset))) if indices is None else [int(i) for i in indices]
    scored = getattr(indices, "num_real", len(order))

    def gen():
        n = len(order)
        for start in range(0, n, batch_size):
            idxs = order[start:min(start + batch_size, n)]
            n_real = min(len(idxs), max(scored - start, 0))
            while len(idxs) < batch_size:
                idxs.append(idxs[-1])
            samples = []
            for idx in idxs:
                s = dataset[int(idx)]
                if raw_u8:
                    s = T.resize_sample(s, min_size, max_size)
                else:
                    s = T.test_transform(s, min_size, max_size)
                # eval masks stay ragged/unpadded — only the host reads them
                samples.append(pad_to_canvas(s, canvas, max_gt, mask_size, pad_masks=False))
            batch = _stack(samples)
            batch["n_real"] = n_real
            if indices is not None:
                batch["index"] = np.asarray(idxs, np.int64)
            yield batch

    return gen()


def make_tta_loader(
    dataset,
    batch_size: int,
    canvas: int,
    tta_k: int = 2,
    max_gt: int = 64,
    mask_size: int | None = None,
    min_size: int = 800,
    max_size: int = 1333,
    seed: int = 3,
):
    """Single-pass test-time-augmentation batches (TEST.TTA; the reference's
    TTABatchCollator and its tta transforms, data/build.py:301-302,
    transforms/build.py:65-79): per sample one resize and ``tta_k``
    jitter-and-erase views, stacked f32 [B, K, canvas, canvas, 3] under
    "tta_views", view 0 also as "image"; the last batch padded as
    ``make_test_loader`` pads it. The reference's model never reads its
    ``tta`` flag (generalized_rcnn.py:42), so TTA is collation only: the
    caller runs each view through the model and merges as it chooses."""
    rng = np.random.default_rng(seed)

    def gen():
        n = len(dataset)
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            n_real = len(idxs)
            idxs += [idxs[-1]] * (batch_size - n_real)
            samples, views = [], []
            for idx in idxs:
                s = T.tta_transform(dataset[int(idx)], rng, tta_k, min_size, max_size)
                vs = s.pop("views")
                h, w = vs[0].shape[:2]
                padded = np.zeros((len(vs), canvas, canvas, 3), np.float32)
                for j, v in enumerate(vs):
                    padded[j, :h, :w] = v
                views.append(padded)
                s["image"] = vs[0]
                samples.append(pad_to_canvas(s, canvas, max_gt, mask_size))
            batch = _stack(samples)
            batch["tta_views"] = np.stack(views)
            batch["n_real"] = n_real
            yield batch

    return gen()


class Prefetcher:
    """Background-thread batch prefetch, in place of the reference's
    multi-worker DataLoader (maskrcnn_benchmark/data/build.py:166-181).
    One daemon thread runs the wrapped iterator's batch assembly
    (windowing, resize, canvas pad, stack: numpy, which releases the GIL
    in its hot loops), so it overlaps the consumer's device dispatch and
    wait. A thread, not a process pool: a batch of numpy arrays crosses a
    thread boundary without a pickle.

    Order-preserving; iterator exceptions re-raise at the consuming
    ``next()``. ``close()`` (also ``__exit__``) stops the thread early
    if the consumer abandons the sweep; otherwise it parks bounded by
    ``depth`` batches ahead (memory cap: depth x batch bytes).
    """

    _ITEM, _ERR, _END = 0, 1, 2

    def __init__(self, batches, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._run, args=(iter(batches),), daemon=True
        )
        self._thread.start()

    def _run(self, it):
        import queue

        def put(msg):
            while not self._stop.is_set():
                try:
                    self._q.put(msg, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for b in it:
                if not put((self._ITEM, b)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            put((self._ERR, e))
            return
        put((self._END, None))

    def __iter__(self):
        return self

    def __next__(self):
        # the _END/_ERR sentinel arrives exactly once — latch it so a
        # next() after exhaustion (or after close()) raises
        # StopIteration instead of parking forever on an empty queue
        if self._done:
            raise StopIteration
        import queue

        while True:
            try:
                kind, val = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._done = True
                    raise StopIteration from None
        if kind == self._ITEM:
            return val
        self._done = True
        if kind == self._ERR:
            raise val
        raise StopIteration

    def close(self):
        self._stop.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch(batches, depth: int = 2):
    """Wrap a batch iterable in a :class:`Prefetcher` (depth 0: no-op).

    depth -1 = auto: 2 with a spare core, 0 on a 1-core host, where the
    thread would contend with the consumer for the core instead of
    overlapping it (the policy of run_inference's eval_workers auto mode).
    """
    if depth < 0:
        depth = 2 if usable_cpus() >= 2 else 0
    return Prefetcher(batches, depth) if depth > 0 else batches


def usable_cpus() -> int:
    """CPUs this process can actually run on. ``os.cpu_count()`` reports
    the machine, ignoring CPU affinity and cgroup pinning."""
    import os

    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1
