"""The port's test-time data path against the JAX package's jax-free data
modules (imported here only): sliding windows, gt cropping, the
synthetic slides, transforms, the test loader (float32 and raw uint8),
the prefetch thread, the catalog and the config keys the serving path
reads. Every array must be identical.
"""

import numpy as np
import pytest
from PIL import Image

from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.data import catalog as jcat
from mmt_psm_tpu.data import loader as jloader
from mmt_psm_tpu.data import pap as jpap
from mmt_psm_tpu.data import transforms as JT
from mmt_psm_tpu_torch.config import get_cfg
from mmt_psm_tpu_torch.data import catalog as cat
from mmt_psm_tpu_torch.data import loader
from mmt_psm_tpu_torch.data import pap
from mmt_psm_tpu_torch.data import transforms as T


def assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("h,w,win,overlap", [(512, 512, 256, 0.0), (700, 1000, 256, 0.75), (200, 300, 256, 0.5),
                                             (1024, 2048, 1000, 0.0)])
def test_generate_windows_identical(h, w, win, overlap):
    assert pap.generate_windows(h, w, win, overlap) == jpap.generate_windows(h, w, win, overlap)


@pytest.mark.parametrize("is_train,overlap", [(False, 0.0), (True, 0.5)])
def test_synthetic_slide_dataset_identical(is_train, overlap):
    """The same seed gives the same slides, windows and window gt (the crop,
    the area filter, the train-time window filter and redraw)."""
    kw = dict(seed=4, num_slides=2, slide_size=256, win_size=128, overlap=overlap, is_train=is_train)
    ours, theirs = pap.synthetic_slide_dataset(**kw), jpap.synthetic_slide_dataset(**kw)
    assert ours.index == theirs.index and len(ours) > 3
    for s, t in zip(ours.slides, theirs.slides):
        assert_same(s, t)
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"item {i}")


def test_crop_window_gt_identical_on_edges():
    """Windows that cut instances at every border, with the tiny-remnant filter."""
    ds = pap.synthetic_slide_dataset(seed=8, num_slides=1, slide_size=300, win_size=128, is_train=False)
    jds = jpap.synthetic_slide_dataset(seed=8, num_slides=1, slide_size=300, win_size=128, is_train=False)
    for x, y in ((0, 0), (100, 37), (172, 172), (250, 5)):
        for cutoff in (0.005, 0.05, 0.5):
            got = pap.crop_window_gt(ds.annotations[0], x, y, 128, cutoff)
            want = jpap.crop_window_gt(jds.annotations[0], x, y, 128, cutoff)
            assert_same(got, want, f"window {(x, y)} cutoff {cutoff}")


@pytest.mark.parametrize("raw_u8", [False, True])
def test_make_test_loader_identical(raw_u8):
    """Every batch (the last one padded by repeating a sample), float32 and
    raw uint8 canvases, ragged eval masks and n_real."""
    kw = dict(seed=5, num_slides=2, slide_size=256, win_size=128, overlap=0.0, is_train=False)
    ds, jds = pap.synthetic_slide_dataset(**kw), jpap.synthetic_slide_dataset(**kw)
    args = (3, 160)
    opts = dict(max_gt=8, min_size=128, max_size=160, raw_u8=raw_u8)
    got = list(loader.make_test_loader(ds, *args, **opts))
    want = list(jloader.make_test_loader(jds, *args, **opts))
    assert len(got) == len(want) == 3 and [b["n_real"] for b in got] == [3, 3, 2]
    assert got[0]["image"].dtype == (np.uint8 if raw_u8 else np.float32)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"batch {i}")


def test_resize_and_normalize_identical():
    """A window that the test transform resizes (PIL bilinear image, nearest
    masks): identical images, boxes and masks."""
    kw = dict(seed=6, num_slides=1, slide_size=200, win_size=200, is_train=False)
    s, js = pap.synthetic_slide_dataset(**kw)[0], jpap.synthetic_slide_dataset(**kw)[0]
    for min_size, max_size in ((256, 256), (144, 1333)):
        assert_same(T.test_transform(s, min_size, max_size), JT.test_transform(js, min_size, max_size))
    rect = dict(s, image=s["image"][:150], masks=s["masks"][:, :150])
    jrect = dict(js, image=js["image"][:150], masks=js["masks"][:, :150])
    assert_same(T.resize_sample(rect, 240, 300), JT.resize_sample(jrect, 240, 300))
    for old, new in ((640, 1066), (1000, 1024), (7, 3)):
        assert_same(T._pil_nearest_index(old, new), JT._pil_nearest_index(old, new))
    img = np.random.default_rng(0).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    assert_same(T.normalize_bgr255(img, [57.0, 57.1, 57.4]), JT.normalize_bgr255(img, [57.0, 57.1, 57.4]))


def test_prefetch_keeps_order_reraises_and_closes():
    got = list(loader.prefetch(iter(range(50)), 3))
    assert got == list(range(50))
    assert loader.prefetch([1, 2], 0) == [1, 2]

    def boom():
        yield 1
        raise ValueError("boom")

    it = loader.prefetch(boom(), 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    p = loader.Prefetcher(iter(range(10**6)), 2)
    assert next(p) == 0
    p.close()
    p._thread.join(timeout=5)
    assert not p._thread.is_alive()
    assert loader.usable_cpus() == jloader.usable_cpus() >= 1


def test_catalog_synthetic_and_disk_identical(tmp_path, monkeypatch):
    """synthetic_val and an on-disk pap split (PNG images and per-instance
    mask PNGs) resolve to the JAX catalog's datasets."""
    ours, theirs = cat.DatasetCatalog.get("synthetic_val"), jcat.DatasetCatalog.get("synthetic_val")
    assert ours.index == theirs.index
    assert_same(ours[0], theirs[0])
    rng = np.random.default_rng(2)
    root = tmp_path / "pap" / "val"
    (root / "images").mkdir(parents=True)
    for k in range(2):
        Image.fromarray(rng.integers(0, 256, (150, 170, 3), dtype=np.uint8)).save(root / "images" / f"s{k}.png")
        (root / "masks" / f"s{k}").mkdir(parents=True)
        for j in range(3):
            m = np.zeros((150, 170), np.uint8)
            y, x = rng.integers(0, 120), rng.integers(0, 140)
            m[y : y + 25, x : x + 20] = 255
            Image.fromarray(m).save(root / "masks" / f"s{k}" / f"{j}_{1 + j % 2}.png")
    monkeypatch.setattr(cat.DatasetCatalog, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jcat.DatasetCatalog, "DATA_DIR", str(tmp_path))
    ours, theirs = cat.build_datasets(("papnuclei_val",)), jcat.build_datasets(("papnuclei_val",))
    assert ours.index == theirs.index and len(ours) == 2
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"item {i}")


@pytest.mark.parametrize("names", ["cell_coco_val", "coco_foo", ("synthetic_val", "synthetic_train")])
def test_catalog_entries_not_ported_raise(names, tmp_path, monkeypatch):
    """Since ROADMAP item 20 every entry resolves as the JAX catalog's does
    (tests/test_torch_port_datasets.py holds the arrays): a COCO entry whose
    files are missing raises as JAX's does, an unknown ``coco_*`` name
    without its directory is unknown, and several names concatenate."""
    monkeypatch.setattr(cat.DatasetCatalog, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jcat.DatasetCatalog, "DATA_DIR", str(tmp_path))
    if names == "cell_coco_val":
        for c in (cat, jcat):
            with pytest.raises(FileNotFoundError):
                c.build_datasets(names)
    elif names == "coco_foo":
        for c in (cat, jcat):
            with pytest.raises(KeyError, match="coco_foo"):
                c.build_datasets(names)
    else:
        ours, theirs = cat.build_datasets(names), jcat.build_datasets(names)
        assert type(ours).__name__ == type(theirs).__name__ == "ConcatDataset"
        assert ours.cumulative_sizes == theirs.cumulative_sizes
        assert_same(ours[len(ours) - 1], theirs[len(theirs) - 1], "last item")
    with pytest.raises(KeyError):
        cat.DatasetCatalog.get("no_such_dataset")


def test_serving_config_keys_match_jax_defaults():
    """The keys the serving path reads have the JAX defaults, and
    ``TEST.IMS_PER_BATCH 4`` merges as an override."""
    ours, theirs = get_cfg(), jax_get_cfg()
    keys = ["INPUT.MIN_SIZE_TEST", "INPUT.MAX_SIZE_TEST", "INPUT.PIXEL_MEAN", "INPUT.PIXEL_STD", "DATASETS.TEST",
            "DATASETS.VAL", "DATASETS.MODE_IN_TEST", "DATALOADER.SIZE_DIVISIBILITY", "DATALOADER.PREFETCH_DEPTH"]
    keys += [f"TEST.{k}" for k in theirs.TEST if not k.startswith("__")]
    for key in keys:
        a, b = ours, theirs
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, key
    ours.merge_from_list(["TEST.IMS_PER_BATCH", "4"])
    assert ours.TEST.IMS_PER_BATCH == 4
