"""The port's host eval against the JAX package's: the C++ library
(``evaluation/_native.py``) against its numpy plain versions and against
the JAX package's build of ``csrc/papeval.cpp``, and Papeval's stats.

Everything here is exact: the same integer counts, the same float64
arithmetic in the same order, and the paste's float32 interpolation built
without FMA contraction on both sides. Inputs come from seeded numpy and
hold ties (equal scores, duplicated masks, equal IoUs), since ties decide
the greedy matchings and the mergesort PR curves.
"""

import os

import numpy as np
import pytest

from mmt_psm_tpu.evaluation import _native as jnative
from mmt_psm_tpu.evaluation import pap_eval as jpe
from mmt_psm_tpu.evaluation.instmask import InstSeg as JInstSeg
from mmt_psm_tpu.evaluation.instmask import iou_int_uni as j_iou_int_uni
from mmt_psm_tpu_torch.evaluation import _native as N
from mmt_psm_tpu_torch.evaluation import pap_eval as pe
from mmt_psm_tpu_torch.evaluation.instmask import InstSeg, iou_int_uni

HW = (96, 112)


def random_masks(rng, n, hw=HW, dup=0.2):
    """n box-cropped masks: integer xyxy boxes and box-local bool arrays,
    about ``dup`` of them exact copies of an earlier one."""
    boxes, masks = [], []
    for _ in range(n):
        if masks and rng.random() < dup:
            k = int(rng.integers(len(masks)))
            boxes.append(list(boxes[k]))
            masks.append(masks[k].copy())
            continue
        w, h = (int(v) for v in rng.integers(2, 40, 2))
        x1, y1 = int(rng.integers(0, hw[1] - w)), int(rng.integers(0, hw[0] - h))
        m = rng.random((h, w)) < rng.uniform(0.3, 0.95)
        m[rng.integers(h), rng.integers(w)] = True
        boxes.append([x1, y1, x1 + w - 1, y1 + h - 1])
        masks.append(m)
    return np.asarray(boxes, np.int64).reshape(-1, 4), masks


def tied_scores(rng, n):
    return rng.integers(0, 6, n) / 5.0


def test_library_builds_into_the_build_dir():
    lib = N.library()
    path = N.library_path()
    assert lib is not None and os.path.dirname(path) == N.BUILD_DIR
    assert os.path.basename(path).startswith("libpapeval_") and path.endswith(".so")
    assert os.path.basename(os.path.dirname(N.BUILD_DIR)) == "mmt_psm_tpu_torch"
    assert "-march=native" not in N.CXX_FLAGS and "-ffp-contract=off" in N.CXX_FLAGS


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no g++, raises: the eval path has
    no numpy fallback."""
    bad = tmp_path / "papeval.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(N, "SOURCE", str(bad))
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.library()
    monkeypatch.setattr(N.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        N.library()
    assert not (tmp_path / "_build").exists() or not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def _case(entry, rng):
    """(port args, JAX native callable or None, JAX args) of one entry point."""
    if entry in ("pair_intersections", "mask_areas"):
        db, dm = random_masks(rng, 23)
        gb, gm = random_masks(rng, 17)
        if entry == "mask_areas":
            return (dm, db), None, None
        return (dm, db, gm, gb), jnative.pair_intersections, (dm, db, gm, gb)
    if entry in ("rle_encode", "rle_decode"):
        m = rng.random((37, 29)) < 0.5
        m[0, 0] = True  # a first run of ones: the counts start with a 0
        if entry == "rle_encode":
            return (m,), jnative.rle_encode, (m,)
        counts = N.rle_encode_plain(m)
        return (counts, 37, 29), jnative.rle_decode, (counts, 37, 29)
    if entry in ("map_matches", "aji_match"):
        d, g = 31, 19
        iou = np.round(rng.random((d, g)) * 8) / 8  # ties, values on the thresholds
        iou[rng.random((d, g)) < 0.5] = 0.0
        iou[3] = iou[1]
        iou[:, 5] = iou[:, 2]
        if entry == "map_matches":
            return (iou, pe.IOU_THRS, d, g), jnative.map_matches, (iou, pe.IOU_THRS, d, g)
        union = rng.integers(50, 5000, (d, g)).astype(np.float64)
        args = (iou, iou * union, union, rng.integers(10, 900, d).astype(np.float64),
                rng.integers(10, 900, g).astype(np.float64))
        return args, jnative.aji_match, args
    assert entry == "paste_resize_threshold"
    probs = rng.random((28, 28)).astype(np.float32)
    probs[rng.random((28, 28)) < 0.2] = 0.5  # exactly on the threshold
    bh, bw = 301, 77
    args = (probs, 1, bh, bw, 3, bh - 5, 0, bw)
    return args + (0.5,), jnative.paste_resize_threshold, args + (0.5,)


@pytest.mark.parametrize("entry", N.ENTRY_POINTS)
def test_entry_point_identical_to_plain_and_to_jax(entry):
    rng = np.random.default_rng(sum(map(ord, entry)))
    args, jax_fn, jax_args = _case(entry, rng)
    got = getattr(N, entry)(*args)
    want = getattr(N, entry + "_plain")(*args)
    others = [want] if jax_fn is None else [want, jax_fn(*jax_args)]
    if entry == "mask_areas":
        others.append(JInstSeg(args[1], args[0]).areas.astype(np.int64))
    for w in others:
        for g_, w_ in zip(got if isinstance(got, tuple) else (got,), w if isinstance(w, tuple) else (w,)):
            g_, w_ = np.asarray(g_), np.asarray(w_)
            assert g_.shape == w_.shape and g_.dtype == w_.dtype, (g_.dtype, w_.dtype)
            np.testing.assert_array_equal(g_, w_)


def test_paste_window_clipped_at_every_border():
    """The paste's window at the box's corners and for boxes of 1 px."""
    rng = np.random.default_rng(5)
    probs = rng.random((28, 28)).astype(np.float32)
    for bh, bw, win in ((30, 30, (0, 30, 0, 30)), (1, 1, (0, 1, 0, 1)), (500, 3, (490, 500, 0, 3)),
                        (64, 640, (0, 1, 600, 640))):
        got = N.paste_resize_threshold(probs, 1, bh, bw, *win, 0.5)
        np.testing.assert_array_equal(got, N.paste_resize_threshold_plain(probs, 1, bh, bw, *win, 0.5))
        np.testing.assert_array_equal(got, jnative.paste_resize_threshold(probs, 1, bh, bw, *win, 0.5))


def test_iou_int_uni_identical_to_jax():
    rng = np.random.default_rng(3)
    db, dm = random_masks(rng, 40)
    gb, gm = random_masks(rng, 30)
    got = iou_int_uni(InstSeg(db, dm), InstSeg(gb, gm))
    want = j_iou_int_uni(JInstSeg(db, dm), JInstSeg(gb, gm))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
    empty = iou_int_uni(InstSeg(np.zeros((0, 4)), []), InstSeg(gb, gm))
    assert all(x.shape == (0, 30) for x in empty)


def _images(seed, n_images=6):
    """Per image {cat: (boxes, masks, scores)} for dt and {cat: (boxes, masks)}
    for gt, dt drawn partly from the gt (so IoUs spread over [0, 1]), with
    tied scores, one image without detections of class 2 and one without
    gt of class 1."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_images):
        dt, gt = {}, {}
        for cat in (1, 2):
            gb, gm = random_masks(rng, int(rng.integers(3, 14)))
            db, dmasks = random_masks(rng, int(rng.integers(2, 12)))
            # detections near gt: a gt mask with pixels flipped
            near = [i for i in range(len(gm)) if rng.random() < 0.6]
            for i in near:
                m = gm[i] ^ (rng.random(gm[i].shape) < 0.15)
                m[0, 0] = True
                db = np.concatenate([db, gb[i : i + 1]])
                dmasks.append(m)
            if not (k == 2 and cat == 2):
                dt[cat] = (db, dmasks, tied_scores(rng, len(dmasks)))
            if not (k == 4 and cat == 1):
                gt[cat] = (gb, gm)
        out.append((dt, gt))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_papeval_summarize_identical_to_jax(seed):
    """The same InstSeg inputs through both evaluators: every per-image row
    and every summary stat identical (ties decide matchings and PR curves)."""
    ours = pe.PapEvaluator(max_dets=20)
    theirs = jpe.PapEvaluator(max_dets=20)
    for dt, gt in _images(seed):
        ours.add_image({c: InstSeg(*v) for c, v in dt.items()}, {c: InstSeg(*v) for c, v in gt.items()})
        theirs.add_image({c: JInstSeg(*v) for c, v in dt.items()}, {c: JInstSeg(*v) for c, v in gt.items()})
    assert len(ours.results) == len(theirs.results) > 0
    for a, b in zip(ours.results, theirs.results):
        for f in ("category_id", "n_gt", "n_dt", "aji", "f1", "fnr", "fdr"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("dt_scores", "map_dtm", "dsc", "tpr"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    got, want = ours.summarize(), theirs.summarize()
    assert got == want
    assert got["AJI"][1] > 0 and got["mAP"]["all"] > 0


def test_papeval_with_plain_versions_identical():
    """Papeval with each library entry point swapped for its plain version
    gives the same rows and stats (what chip_smoke.py checks on the card's
    host)."""
    images = _images(7)

    def run():
        ev = pe.PapEvaluator()
        for dt, gt in images:
            ev.add_image({c: InstSeg(*v) for c, v in dt.items()}, {c: InstSeg(*v) for c, v in gt.items()})
        return ev.summarize()

    got = run()
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        for entry in N.ENTRY_POINTS:
            m.setattr(N, entry, getattr(N, entry + "_plain"))
        want = run()
    assert got == want
