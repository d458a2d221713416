"""Whether the served detections are those of the plain reference.

For a sample of the window's batches (the served boxes, scores, labels,
valid flags and float16 mask probabilities, as fetched), the reference
(``perfbench/reference``, in the configuration's own precision, with the
plain NMS and ROIAlign) runs the same canvases with weights made again
from the seed. Three numbers:

* ``unmatched``: the share of detections, served and reference together,
  that have no detection of the same label at IoU >= 0.9 on the other side.
  A detection that the program adds, drops or moves counts, as does one
  the reference has and the program does not.
* ``score_gap``: the widest gap between a served score and that of its
  best reference match, over max(1, |reference score|).
* ``mask_gap``: the widest gap between a served mask probability and the
  reference's mask head and mask relation module run on the served boxes
  and labels: each served detection is scored as the reference would have
  scored it, as a served model's tokens are.

A number is compared only where the cell's file gives it a limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..harness.weights import fill
from ..reference import serve as RS
from ..reference.build import reference_model

MATCH_IOU = 0.9


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU in the detector's own convention, pixel-inclusive (+1 on
    each side), so that a box clipped to zero width still matches itself."""
    area = lambda x: np.clip(x[:, 2] - x[:, 0] + 1, 0, None) * np.clip(x[:, 3] - x[:, 1] + 1, 0, None)  # noqa: E731
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt + 1, 0, None), -1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


class Tally:
    """The three numbers over any number of judged images."""

    def __init__(self):
        self.unmatched = self.total = 0
        self.score_gap = self.mask_gap = 0.0
        self.images = 0

    def add(self, served, ref, tf_masks):
        """``served``/``ref``: (boxes [B,K,4], scores [B,K], labels [B,K],
        valid [B,K], masks [B,K,R,R]); ``tf_masks`` the reference's masks
        on the served detections [B,K,R,R]."""
        sb, ss, sl, sv, sm = served
        rb, rs, rl, rv = ref[:4]
        for i in range(sb.shape[0]):
            self.images += 1
            s_idx, r_idx = np.flatnonzero(sv[i]), np.flatnonzero(rv[i])
            if len(s_idx) and len(r_idx):
                q = _iou(sb[i, s_idx], rb[i, r_idx]) * (sl[i, s_idx][:, None] == rl[i, r_idx][None])
                best_s, best_r = q.max(1), q.max(0)
                m = best_s >= MATCH_IOU
                if m.any():
                    j = r_idx[q.argmax(1)[m]]
                    s = ss[i, s_idx[m]]
                    gap = np.abs(s - rs[i, j]) / np.maximum(1.0, np.abs(rs[i, j]))
                    self.score_gap = max(self.score_gap, float(gap.max()))
            else:
                best_s, best_r = np.zeros(len(s_idx)), np.zeros(len(r_idx))
            self.unmatched += int((best_s < MATCH_IOU).sum() + (best_r < MATCH_IOU).sum())
            self.total += len(s_idx) + len(r_idx)
            if len(s_idx):
                gap = np.abs(sm[i, s_idx].astype(np.float32) - tf_masks[i, s_idx])
                self.mask_gap = max(self.mask_gap, float(gap.max()))

    def numbers(self) -> dict:
        return {"unmatched": self.unmatched / max(self.total, 1), "score_gap": self.score_gap,
                "mask_gap": self.mask_gap}


def reference_net(conf: dict, seed: int, device):
    return fill(reference_model(conf["model"], device), seed, conf["init"]).eval()


def tally(net, served_batches, images_of, sizes, device) -> Tally:
    """Judge ``served_batches`` [(pool index, served outputs)]; ``images_of``
    gives a pool index's canvases [B, H, W, 3] uint8 on the host."""
    t = Tally()
    by_pool = {}
    for j, out in served_batches:
        by_pool.setdefault(j, []).append(out)
    sz = torch.from_numpy(sizes).to(device)
    for j, outs in sorted(by_pool.items()):
        ref, feats = RS.detect(net, images_of(j).to(device), sz)
        ref_np = tuple(x.cpu().numpy() for x in (ref.boxes, ref.scores, ref.labels, ref.valid))
        for out in outs:
            boxes, scores, labels, valid, masks = out[:5]
            tf = RS.masks_on(net, feats, torch.from_numpy(boxes).to(device),
                             torch.from_numpy(labels).to(device), torch.from_numpy(valid).to(device))
            t.add((boxes, scores, labels, valid, masks), ref_np, tf.float().cpu().numpy())
        del ref, feats
    return t


def check(conf, seed, device, kept, host, sizes, batch, spec) -> dict:
    """Judge ``kept`` [(pool index, served outputs)]: {number: (value,
    limit)} of the numbers the cell's ``check`` limits;
    every number is printed to standard error as a reading."""
    import sys

    net = reference_net(conf, seed, device)
    t = tally(net, kept, lambda p: host[p * batch:(p + 1) * batch], sizes, device)
    nums = t.numbers()
    print(f"reading over {t.images} images, {t.total} detections: " +
          " ".join(f"{k}={v!r}" for k, v in nums.items()), file=sys.stderr)
    return {k: (nums[k], lim) for k, lim in spec["limits"].items()}
