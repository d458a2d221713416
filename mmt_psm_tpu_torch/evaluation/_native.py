"""The host eval library ``csrc/papeval.cpp`` through ctypes, and the plain
numpy version of each of its entry points.

The library is built with ``g++`` at first use into
``mmt_psm_tpu_torch/_build/`` (listed in ``.gitignore``), never next to
its source. The file name carries a hash of the source, the flags, the
compiler's version and the machine, so an edited source, another
compiler or another machine's build is never loaded; it is written to a
temporary file and moved into place with ``os.replace``, so processes
that build at once never load a half-written library. The flags carry
no ``-march=native``. ``-ffp-contract=off`` keeps every float multiply
and add separately rounded, so ``paste_resize_threshold`` is
bit-identical to the numpy float32 arithmetic of
``paste_resize_threshold_plain``.

The eval path calls the library's entry points only: a failed build
raises. Each ``*_plain`` function computes the same result in numpy (the
JAX package's fallback path) for the tests and ``chip_smoke.py`` to hold
the library against. Nothing is built or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "papeval.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
# entry point -> (argtypes, restype)
SIGNATURES = {
    "pair_intersections": ([_u8p, _i64p, _i64p, _i64] * 2 + [_i64p], None),
    "mask_areas": ([_u8p, _i64p, _i64p, _i64, _i64p], None),
    "rle_encode": ([_u8p, _i64, _i64, _i64p], _i64),
    "rle_decode": ([_i64p, _i64, _i64, _i64, _u8p], None),
    "map_matches": ([_f64p, _i64, _i64, _f64p, _i64, _f64p, _f64p], None),
    "aji_match": ([_f64p, _f64p, _f64p, _i64, _i64, _f64p, _f64p], ctypes.c_double),
    "paste_resize_threshold": ([_f32p] + [_i64] * 8 + [ctypes.c_float, _u8p], None),
}

_lib: ctypes.CDLL | None = None
_path: str | None = None
_lock = threading.Lock()


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host eval library csrc/papeval.cpp needs it")
    return cxx


def _build() -> str:
    cxx = _cxx()
    version = subprocess.run([cxx, "-dumpfullversion", "-dumpversion"], capture_output=True, text=True).stdout
    with open(SOURCE, "rb") as f:
        key = f.read() + " ".join(CXX_FLAGS).encode() + version.encode() + platform.machine().encode()
    out = os.path.join(BUILD_DIR, f"libpapeval_{hashlib.sha256(key).hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The built and loaded library (built at the first call)."""
    global _lib, _path
    with _lock:
        if _lib is None:
            path = _build()
            lib = ctypes.CDLL(path)
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib, _path = lib, path
        return _lib


def library_path() -> str | None:
    """The file the library was loaded from, or None before the first call."""
    return _path


def _pack(masks, boxes):
    """Concatenate row-major u8 box-cropped masks, with each one's offset."""
    sizes = np.array([m.size for m in masks], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    data = np.empty(int(sizes.sum()), np.uint8)
    for off, m in zip(offsets, masks):
        data[off : off + m.size] = np.ascontiguousarray(m, np.uint8).ravel()
    return data, offsets, np.ascontiguousarray(boxes, np.int64).reshape(-1, 4)


# ------------------------------------------------------------ intersections
def pair_intersections(dt_masks, dt_boxes, gt_masks, gt_boxes) -> np.ndarray:
    """[D, G] int64 intersection counts of box-cropped masks."""
    d, g = len(dt_masks), len(gt_masks)
    out = np.zeros((d, g), np.int64)
    if d == 0 or g == 0:
        return out
    lib = library()
    ddata, doff, dbox = _pack(dt_masks, dt_boxes)
    gdata, goff, gbox = _pack(gt_masks, gt_boxes)
    lib.pair_intersections(
        ddata.ctypes.data_as(_u8p), doff.ctypes.data_as(_i64p), dbox.ctypes.data_as(_i64p), d,
        gdata.ctypes.data_as(_u8p), goff.ctypes.data_as(_i64p), gbox.ctypes.data_as(_i64p), g,
        out.ctypes.data_as(_i64p),
    )
    return out


def pair_intersections_plain(dt_masks, dt_boxes, gt_masks, gt_boxes) -> np.ndarray:
    out = np.zeros((len(dt_masks), len(gt_masks)), np.int64)
    for i, (ba, ma) in enumerate(zip(np.asarray(dt_boxes, np.int64).reshape(-1, 4), dt_masks)):
        for j, (bb, mb) in enumerate(zip(np.asarray(gt_boxes, np.int64).reshape(-1, 4), gt_masks)):
            x1, y1 = max(ba[0], bb[0]), max(ba[1], bb[1])
            x2, y2 = min(ba[2], bb[2]), min(ba[3], bb[3])
            if x2 < x1 or y2 < y1:
                continue
            a = ma[y1 - ba[1] : y2 - ba[1] + 1, x1 - ba[0] : x2 - ba[0] + 1]
            b = mb[y1 - bb[1] : y2 - bb[1] + 1, x1 - bb[0] : x2 - bb[0] + 1]
            out[i, j] = np.count_nonzero(a & b)
    return out


def mask_areas(masks, boxes) -> np.ndarray:
    """[N] int64 pixel counts of box-cropped masks."""
    out = np.zeros(len(masks), np.int64)
    if len(masks) == 0:
        return out
    data, off, box = _pack(masks, boxes)
    library().mask_areas(data.ctypes.data_as(_u8p), off.ctypes.data_as(_i64p), box.ctypes.data_as(_i64p),
                         len(masks), out.ctypes.data_as(_i64p))
    return out


def mask_areas_plain(masks, boxes) -> np.ndarray:
    return np.array([np.count_nonzero(m) for m in masks], np.int64)


# ---------------------------------------------------------------- RLE codec
def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Column-major RLE counts (pycocotools semantics: the first run counts
    zeros) of an [H, W] mask."""
    h, w = mask.shape
    m = np.ascontiguousarray(mask != 0, np.uint8)
    counts = np.empty(h * w + 1, np.int64)
    n = library().rle_encode(m.ctypes.data_as(_u8p), h, w, counts.ctypes.data_as(_i64p))
    return counts[:n].copy()


def rle_encode_plain(mask: np.ndarray) -> np.ndarray:
    flat = np.ascontiguousarray(mask != 0, np.uint8).T.ravel()  # column-major scan
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
    if flat.size and flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W] u8 mask of column-major RLE counts."""
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.empty((h, w), np.uint8)
    library().rle_decode(counts.ctypes.data_as(_i64p), len(counts), h, w, out.ctypes.data_as(_u8p))
    return out


def rle_decode_plain(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, v = 0, 0
    for c in np.asarray(counts, np.int64):
        if v:
            flat[pos : pos + c] = 1
        pos += int(c)
        v ^= 1
    return flat.reshape(w, h).T.copy()


# ----------------------------------------------------------------- matching
def map_matches(ious: np.ndarray, thrs: np.ndarray, n_dt: int, n_gt: int):
    """COCO-style greedy (dtm, gtm) per IoU threshold over score-sorted
    detections (reference pap_eval.py:480-509): each detection takes the
    still-unmatched gt of the highest IoU at or above the running bar,
    the later gt on a tie, with the bar clamped to 1 - 1e-10."""
    t = len(thrs)
    dtm = np.zeros((t, n_dt), np.float64)
    gtm = np.zeros((t, n_gt), np.float64)
    if n_dt == 0 or n_gt == 0 or ious is None or np.size(ious) == 0:
        return dtm, gtm
    ious = np.ascontiguousarray(ious, np.float64)
    # the counts are raw strides in C++: a mismatch would read out of bounds
    assert ious.shape == (n_dt, n_gt), (ious.shape, n_dt, n_gt)
    thrs = np.ascontiguousarray(thrs, np.float64)
    library().map_matches(ious.ctypes.data_as(_f64p), n_dt, n_gt, thrs.ctypes.data_as(_f64p), t,
                          dtm.ctypes.data_as(_f64p), gtm.ctypes.data_as(_f64p))
    return dtm, gtm


def map_matches_plain(ious: np.ndarray, thrs: np.ndarray, n_dt: int, n_gt: int):
    t = len(thrs)
    dtm = np.zeros((t, n_dt))
    gtm = np.zeros((t, n_gt))
    if n_dt == 0 or n_gt == 0 or ious is None or np.size(ious) == 0:
        return dtm, gtm
    for tind, thr in enumerate(thrs):
        for dind in range(n_dt):
            iou = min(thr, 1 - 1e-10)
            m = -1
            for gind in range(n_gt):
                if gtm[tind, gind] > 0 or ious[dind, gind] < iou:
                    continue
                iou = ious[dind, gind]
                m = gind
            if m == -1:
                continue
            dtm[tind, dind] = m + 1
            gtm[tind, m] = dind + 1
    return dtm, gtm


def aji_match(ious, inter, union, dt_areas, gt_areas) -> float:
    """Per-image AJI (reference pap_eval.py:573-630): each gt in turn takes
    the still-unmatched detection of the highest IoU at or above 0.5 (the
    later one on a tie), adding the pair's intersection and union; the
    areas of unmatched detections and gt add to the union. I / U, or 0."""
    if ious is None or np.size(ious) == 0:
        return 0.0
    ious = np.ascontiguousarray(ious, np.float64)
    d, g = ious.shape
    inter = np.ascontiguousarray(inter, np.float64)
    union = np.ascontiguousarray(union, np.float64)
    dt_areas = np.ascontiguousarray(dt_areas, np.float64)
    gt_areas = np.ascontiguousarray(gt_areas, np.float64)
    assert inter.shape == (d, g) and union.shape == (d, g), (inter.shape, union.shape)
    assert len(dt_areas) == d and len(gt_areas) == g, (len(dt_areas), len(gt_areas), d, g)
    return float(library().aji_match(
        ious.ctypes.data_as(_f64p), inter.ctypes.data_as(_f64p), union.ctypes.data_as(_f64p), d, g,
        dt_areas.ctypes.data_as(_f64p), gt_areas.ctypes.data_as(_f64p),
    ))


def aji_match_plain(ious, inter, union, dt_areas, gt_areas) -> float:
    if ious is None or np.size(ious) == 0:
        return 0.0
    d, g = ious.shape
    gt_matched = np.zeros(g, bool)
    dt_matched = np.zeros(d, bool)
    i_sum = u_sum = 0.0
    for gind in range(g):
        iou = min(0.5, 1 - 1e-10)
        m = -1
        _i = _u = 0.0
        for dind in range(d):
            if dt_matched[dind] or ious[dind, gind] < iou:
                continue
            iou = ious[dind, gind]
            _i, _u = inter[dind, gind], union[dind, gind]
            m = dind
        if m == -1:
            continue
        dt_matched[m] = gt_matched[gind] = True
        i_sum += _i
        u_sum += _u
    u_sum += np.asarray(dt_areas)[~dt_matched].sum() + np.asarray(gt_areas)[~gt_matched].sum()
    return i_sum / u_sum if u_sum > 0 else 0.0


# -------------------------------------------------------------------- paste
def paste_resize_threshold(probs: np.ndarray, pad: int, bh: int, bw: int,
                           oy0: int, oy1: int, ox0: int, ox1: int, threshold: float) -> np.ndarray:
    """Window [oy0, oy1) x [ox0, ox1) of the bilinear resize (half-pixel
    grid) of the zero-padded [m, m] probability map to bh x bw, above
    ``threshold``: the Masker paste's hot loop (``engine/paste.py``)."""
    m = probs.shape[-1]
    probs = np.ascontiguousarray(probs, np.float32)
    assert probs.shape == (m, m), probs.shape
    out = np.empty((oy1 - oy0, ox1 - ox0), np.uint8)
    library().paste_resize_threshold(probs.ctypes.data_as(_f32p), m, pad, bh, bw, oy0, oy1, ox0, ox1,
                                     ctypes.c_float(threshold), out.ctypes.data_as(_u8p))
    return out.view(bool)


def paste_resize_threshold_plain(probs: np.ndarray, pad: int, bh: int, bw: int,
                                 oy0: int, oy1: int, ox0: int, ox1: int, threshold: float) -> np.ndarray:
    from ..engine.paste import _bilinear_resize

    m = probs.shape[-1]
    padded = np.zeros((m + 2 * pad, m + 2 * pad), np.float32)
    padded[pad : m + pad, pad : m + pad] = probs
    return np.ascontiguousarray((_bilinear_resize(padded, bh, bw) > threshold)[oy0:oy1, ox0:ox1])


ENTRY_POINTS = ("pair_intersections", "mask_areas", "rle_encode", "rle_decode", "map_matches", "aji_match",
                "paste_resize_threshold")
