"""The port's datasets against the JAX package's on the CPU: the ``CELL``
index, ``COCODataset`` (polygon, RLE, box-only, crowd and degenerate
annotations), ``ListDataset``, ``ConcatDataset``, ``PascalVOCDataset``, the
catalog's resolution of ``coco_*`` directories, COCO entries, registered
list and VOC entries and several names, and the TTA transform and loader.
The same files on disk (``torch_port_datasets``), the same seeds: every
array identical.
"""

import json
import os

import numpy as np
import pytest

import torch_port_datasets as D
from mmt_psm_tpu.data import catalog as jcat
from mmt_psm_tpu.data import cell as jcell
from mmt_psm_tpu.data import coco as jcoco
from mmt_psm_tpu.data import concat as jconcat
from mmt_psm_tpu.data import loader as jloader
from mmt_psm_tpu.data import transforms as jT
from mmt_psm_tpu.data import voc as jvoc
from mmt_psm_tpu_torch.data import catalog as cat
from mmt_psm_tpu_torch.data import cell, coco, concat, loader, voc
from mmt_psm_tpu_torch.data import transforms as T
from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset

INDEX_QUERIES = {
    "all_anns": ("getAnnIds", {}),
    "anns_of_an_image": ("getAnnIds", {"imgIds": 11}),
    "anns_of_images": ("getAnnIds", {"imgIds": [10, 12, 99]}),
    "anns_of_a_category": ("getAnnIds", {"catIds": 9}),
    "anns_in_an_area_range": ("getAnnIds", {"areaRng": [20, 200]}),
    "crowd_anns": ("getAnnIds", {"iscrowd": 1}),
    "non_crowd_anns_of_image_and_category": ("getAnnIds", {"imgIds": [10, 11], "catIds": [7], "iscrowd": 0}),
    "all_categories": ("getCatIds", {}),
    "categories_by_name": ("getCatIds", {"catNms": ["nuclei", "debris"]}),
    "categories_by_supercategory": ("getCatIds", {"supNms": "cell"}),
    "categories_by_id": ("getCatIds", {"catIds": [3, 9]}),
    "images_of_categories": ("getImgIds", {"catIds": [7, 9]}),
    "images_by_id_and_category": ("getImgIds", {"imgIds": [10, 11, 13], "catIds": 7}),
}


@pytest.fixture(scope="module")
def coco_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco_split"))
    return D.write_coco(root, seed=0, n_images=4)


@pytest.mark.parametrize("query", sorted(INDEX_QUERIES))
def test_cell_index_matches_jax(coco_split, query):
    ann_file, _, data = coco_split
    ours, theirs = cell.CELL(ann_file), jcell.CELL(ann_file)
    method, kw = INDEX_QUERIES[query]
    got, want = getattr(ours, method)(**kw), getattr(theirs, method)(**kw)
    if method == "getImgIds":
        got, want = sorted(got), sorted(want)
    assert got == want
    if method == "getAnnIds":
        assert ours.loadAnns(got) == theirs.loadAnns(want)
    assert ours.loadImgs([10, 13]) == theirs.loadImgs([10, 13]) and ours.loadCats(9) == theirs.loadCats(9)
    assert dict(ours.imgToAnns) == dict(theirs.imgToAnns) and dict(ours.catToImgs) == dict(theirs.catToImgs)
    assert cell.CELL(data).anns == ours.anns  # a dict indexes as its file does


@pytest.mark.parametrize("remove_empty", [True, False])
def test_coco_dataset_samples_identical(coco_split, remove_empty):
    ann_file, img_dir, _ = coco_split
    ours = coco.COCODataset(ann_file, img_dir, remove_empty)
    theirs = jcoco.COCODataset(ann_file, img_dir, remove_empty)
    assert ours.ids == theirs.ids and len(ours) == (4 if remove_empty else 5)
    assert ours.json_category_id_to_contiguous_id == theirs.json_category_id_to_contiguous_id == {3: 1, 7: 2, 9: 3}
    for i in range(len(ours)):
        assert ours.get_img_info(i) == theirs.get_img_info(i)
        D.assert_same(ours[i], theirs[i], f"item {i}")


@pytest.mark.parametrize("kind", ["polygon", "rle", "box", "crowd", "degenerate"])
def test_coco_annotation_kinds(tmp_path, kind):
    """One annotation kind an image, categories 7 and 9 only: labels 1 and 2
    (an off-by-one mapping of the ids would give 0 or 3)."""
    ann_file, img_dir, data = D.write_coco(str(tmp_path), seed=1, n_images=3, kinds=(kind,))
    data["categories"] = data["categories"][:2]
    with open(ann_file, "w") as f:
        json.dump(data, f)
    ours, theirs = coco.COCODataset(ann_file, img_dir), jcoco.COCODataset(ann_file, img_dir)
    assert ours.json_category_id_to_contiguous_id == {7: 1, 9: 2}
    for i in range(len(ours)):
        got = ours[i]
        D.assert_same(got, theirs[i], f"{kind} item {i}")
        n = 0 if kind in ("crowd", "degenerate") else 1  # both dropped
        assert len(got["labels"]) == n and set(got["labels"].tolist()) <= {1, 2}
        if kind == "rle":
            ann = data["annotations"][i]
            x, y, bw, bh = ann["bbox"]
            np.testing.assert_array_equal(got["boxes"][0], [x, y, x + bw - 1, y + bh - 1])
            assert int(got["masks"][0].sum()) == ann["area"]


def test_rle_is_column_major():
    """A 2 x 3 mask: a row-major decoder passes on square masks only."""
    from mmt_psm_tpu.evaluation import _native as jnative
    from mmt_psm_tpu_torch.evaluation import _native

    m = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    counts = _native.rle_encode(m)
    np.testing.assert_array_equal(counts, [0, 1, 1, 2, 1, 1])  # columns (1, 0), (1, 1), (0, 1)
    np.testing.assert_array_equal(_native.rle_decode(counts, 2, 3), m)
    np.testing.assert_array_equal(jnative.rle_decode(counts, 2, 3), m)
    seg = {"size": [2, 3], "counts": counts.tolist()}
    from mmt_psm_tpu_torch.utils.segms import rle_to_mask

    np.testing.assert_array_equal(rle_to_mask(seg), m)


@pytest.mark.parametrize("seed", range(3))
def test_rasterize_polygons_identical(seed):
    rng = np.random.default_rng(seed)
    polys = [rng.uniform(-3, 40, 2 * int(rng.integers(3, 9))).tolist() for _ in range(3)] + [[1.0, 2.0, 3.0, 4.0]]
    got, want = coco.rasterize_polygons(polys, 37, 41), jcoco.rasterize_polygons(polys, 37, 41)
    D.assert_same(got, want)
    assert got.any()


def _list_files(root, rng, n=3, h=24, w=30):
    from PIL import Image

    paths, anns = [], []
    for i in range(n):
        p = os.path.join(root, f"l{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
        k = int(rng.integers(0, 3))
        anns.append(None if i == 1 else {"boxes": rng.uniform(0, 20, (k, 4)).tolist(), "labels": [1] * k,
                                         "masks": (rng.random((k, h, w)) < 0.3).astype(np.uint8)})
    return paths, anns


def test_list_dataset_identical(tmp_path):
    paths, anns = _list_files(str(tmp_path), np.random.default_rng(0))
    ours, theirs = concat.ListDataset(paths, anns), jconcat.ListDataset(paths, anns)
    assert len(ours) == 3
    for i in range(3):
        assert ours.get_img_info(i) == theirs.get_img_info(i)
        D.assert_same(ours[i], theirs[i], f"item {i}")
    D.assert_same(concat.ListDataset(paths)[2], jconcat.ListDataset(paths)[2])
    with pytest.raises(ValueError):
        concat.ListDataset(paths, anns[:2])


def test_concat_dataset_identical(coco_split, tmp_path):
    ann_file, img_dir, _ = coco_split
    paths, anns = _list_files(str(tmp_path), np.random.default_rng(1))
    ours = concat.ConcatDataset([coco.COCODataset(ann_file, img_dir), concat.ListDataset(paths, anns),
                                 coco.COCODataset(ann_file, img_dir, False)])
    theirs = jconcat.ConcatDataset([jcoco.COCODataset(ann_file, img_dir), jconcat.ListDataset(paths, anns),
                                    jcoco.COCODataset(ann_file, img_dir, False)])
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        assert ours.get_idxs(i) == theirs.get_idxs(i)
        assert ours.get_img_info(i) == theirs.get_img_info(i)
        D.assert_same(ours[i], theirs[i], f"item {i}")
    with pytest.raises(ValueError):
        concat.ConcatDataset([])


@pytest.mark.parametrize("use_difficult", [True, False])
def test_voc_dataset_identical(tmp_path, use_difficult):
    D.write_voc(str(tmp_path), seed=2, n_images=4)
    ours = voc.PascalVOCDataset(str(tmp_path), "trainval", use_difficult)
    theirs = jvoc.PascalVOCDataset(str(tmp_path), "trainval", use_difficult)
    assert ours.ids == theirs.ids and ours.CLASSES == theirs.CLASSES and len(ours.CLASSES) == 21
    n_difficult = 0
    for i in range(len(ours)):
        D.assert_same(ours.get_groundtruth(i), theirs.get_groundtruth(i), f"gt {i}")
        assert ours.get_img_info(i) == theirs.get_img_info(i) == {"height": 60, "width": 80}
        D.assert_same(ours[i], theirs[i], f"item {i}")
        n_difficult += int(ours.get_groundtruth(i)["difficult"].sum())
    assert (n_difficult > 0) == use_difficult
    assert ours.map_class_id_to_class_name(12) == "dog"


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """DATA_DIR of both catalogs at tmp_path, holding ``coco_syn`` (the
    ``coco_*`` layout), ``cell_coco/{val,annotations/val.json}`` and
    ``voc/``; the registered entries removed afterwards."""
    root = str(tmp_path)
    D.write_coco(os.path.join(root, "coco_syn"), seed=3, n_images=2)
    ann_file, _, _ = D.write_coco(os.path.join(root, "cell_coco"), seed=4, n_images=2, img_subdir="val")
    os.makedirs(os.path.join(root, "cell_coco", "annotations"))
    os.replace(ann_file, os.path.join(root, "cell_coco", "annotations", "val.json"))
    D.write_voc(os.path.join(root, "voc"), seed=5, n_images=2, split="test")
    for c in (cat.DatasetCatalog, jcat.DatasetCatalog):
        monkeypatch.setattr(c, "DATA_DIR", root)
        monkeypatch.setattr(c, "DATASETS", dict(c.DATASETS))
    return root


def _registered(root):
    paths, anns = _list_files(root, np.random.default_rng(6))
    return {"my_list": {"factory": "ListDataset", "image_paths": paths, "annotations": anns},
            "my_voc": {"factory": "PascalVOCDataset", "split": "test", "use_difficult": True}}


@pytest.mark.parametrize("names", [("coco_syn",), "cell_coco_val", ("my_list",), ("my_voc",),
                                   ("coco_syn", "synthetic_val"), ("my_voc", "cell_coco_val", "my_list")])
def test_catalog_resolves_as_jax(data_dir, names):
    for name, attrs in _registered(data_dir).items():
        cat.DatasetCatalog.register(name, **attrs)
        jcat.DatasetCatalog.register(name, **attrs)
    ours, theirs = cat.build_datasets(names), jcat.build_datasets(names)
    assert type(ours).__name__ == type(theirs).__name__
    several = not isinstance(names, str) and len(names) > 1
    assert isinstance(ours, concat.ConcatDataset) == several
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        D.assert_same(ours[i], theirs[i], f"{names} item {i}")


def test_catalog_unknown_names_raise(data_dir):
    with pytest.raises(KeyError, match="coco_missing"):
        cat.build_datasets(("coco_missing",))  # no DATA_DIR/coco_missing/annotations.json
    with pytest.raises(KeyError):
        cat.DatasetCatalog.get("no_such_dataset")
    with pytest.raises(ValueError):
        cat.build_datasets(())
    cat.DatasetCatalog.register("odd", factory="NoSuchFactory")
    with pytest.raises(KeyError, match="NoSuchFactory"):
        cat.DatasetCatalog.get("odd")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_tta_transform_identical(k):
    sample = synthetic_slide_dataset(seed=8, num_slides=1, slide_size=96, win_size=96, is_train=False)[0]
    got = T.tta_transform(sample, np.random.default_rng(k), k, min_size=64, max_size=96)
    want = jT.tta_transform(sample, np.random.default_rng(k), k, min_size=64, max_size=96)
    D.assert_same(got, want)
    assert len(got["views"]) == k and got["views"][0].shape == (64, 64, 3)


@pytest.mark.parametrize("batch,k", [(2, 2), (3, 1), (4, 3)])
def test_make_tta_loader_identical(coco_split, batch, k):
    """TTA batches over a COCO split of 40 x 56 images on a 64 canvas: the
    last batch padded, every array identical."""
    ann_file, img_dir, _ = coco_split
    ds, jds = coco.COCODataset(ann_file, img_dir), jcoco.COCODataset(ann_file, img_dir)
    kw = dict(tta_k=k, max_gt=8, min_size=40, max_size=64, seed=5)
    got = list(loader.make_tta_loader(ds, batch, 64, **kw))
    want = list(jloader.make_tta_loader(jds, batch, 64, **kw))
    assert len(got) == len(want) == -(-len(ds) // batch)
    D.assert_same(got, want)
    assert got[0]["tta_views"].shape == (batch, k, 64, 64, 3)
    np.testing.assert_array_equal(got[0]["tta_views"][:, 0], got[0]["image"])
    assert got[-1]["n_real"] == len(ds) - batch * (len(got) - 1)
