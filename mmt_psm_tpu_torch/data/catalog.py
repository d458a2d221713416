"""Dataset catalog: name -> dataset (the port's copy of the pap and
synthetic entries of ``mmt_psm_tpu/data/catalog.py``, after the
reference's paths catalog, maskrcnn_benchmark/config/paths_catalog.py).

The labeled pap splits map to ``PapDataset`` over an on-disk layout under
DATA_DIR (``pap/<split>/images/*.png`` and
``pap/<split>/masks/<image>/<instance>_<label>.png``), the unlabeled one
to ``PapUnlabeledDataset`` over ``pap/no_label/*.png`` (and ``*.jpg``);
``synthetic_*`` give a self-contained set. ``COCODataset`` entries name an
image directory and an annotation JSON under DATA_DIR, and any unknown
``coco_<name>`` with ``DATA_DIR/coco_<name>/annotations.json`` resolves to
``COCODataset`` over ``DATA_DIR/coco_<name>/images``. ``ListDataset`` and
``PascalVOCDataset`` entries are registered with ``register``.
``build_datasets`` concatenates several names.
"""

from __future__ import annotations

import os

import numpy as np


class DatasetCatalog:
    DATA_DIR = os.environ.get("MMT_PSM_DATA_DIR", "datasets")

    DATASETS = {
        "papnuclei_train": {"factory": "PapDataset", "split": "train", "is_train": True, "overlap": 0.75},
        # the labeled MT split: both foreground classes in every patch (Pap.py:570-573)
        "papnuclei_source": {"factory": "PapDataset", "split": "train", "is_train": True, "overlap": 0.75,
                             "require_both_classes": True},
        "papnuclei_val": {"factory": "PapDataset", "split": "val", "is_train": False, "overlap": 0.0},
        "papnuclei_test": {"factory": "PapDataset", "split": "test", "is_train": False, "overlap": 0.0},
        "papnuclei_no_label": {"factory": "PapUnlabeledDataset", "split": "no_label"},
        "synthetic_train": {"factory": "synthetic", "is_train": True, "seed": 0},
        "synthetic_val": {"factory": "synthetic", "is_train": False, "seed": 42},
        "cell_coco_train": {"factory": "COCODataset", "root": "cell_coco/train",
                            "ann_file": "cell_coco/annotations/train.json"},
        "cell_coco_val": {"factory": "COCODataset", "root": "cell_coco/val",
                          "ann_file": "cell_coco/annotations/val.json"},
        "cell_coco_test": {"factory": "COCODataset", "root": "cell_coco/test",
                           "ann_file": "cell_coco/annotations/test.json"},
    }

    @classmethod
    def register(cls, name: str, **attrs):
        """Add an entry at run time (user datasets, tests)."""
        cls.DATASETS[name] = attrs

    @classmethod
    def get(cls, name: str):
        if name not in cls.DATASETS:
            # the on-disk convention of any other coco_* name
            root = os.path.join(cls.DATA_DIR, name)
            if name.startswith("coco_") and os.path.isfile(os.path.join(root, "annotations.json")):
                from .coco import COCODataset

                return COCODataset(os.path.join(root, "annotations.json"), os.path.join(root, "images"))
            raise KeyError(f"unknown dataset {name!r}; known: {sorted(cls.DATASETS)}")
        attrs = dict(cls.DATASETS[name])
        factory = attrs.pop("factory")
        if factory == "synthetic":
            from .pap import synthetic_slide_dataset

            kw = {k: v for k, v in attrs.items() if k not in ("seed", "is_train")}
            return synthetic_slide_dataset(seed=attrs.get("seed", 0), is_train=attrs.get("is_train", True), **kw)
        if factory == "PapUnlabeledDataset":
            from .pap import PapUnlabeledDataset

            root = os.path.join(cls.DATA_DIR, "pap", attrs["split"])
            patches = sorted(os.path.join(root, f) for f in os.listdir(root)
                             if f.endswith((".png", ".jpg"))) if os.path.isdir(root) else []
            return PapUnlabeledDataset(patches)
        if factory == "COCODataset":
            from .coco import COCODataset

            ann, root = (p if os.path.isabs(p) else os.path.join(cls.DATA_DIR, p)
                         for p in (attrs["ann_file"], attrs["root"]))
            return COCODataset(ann, root, attrs.get("remove_images_without_annotations", True))
        if factory == "ListDataset":
            from .concat import ListDataset

            return ListDataset(attrs["image_paths"], attrs.get("annotations"))
        if factory == "PascalVOCDataset":
            from .voc import PascalVOCDataset

            return PascalVOCDataset(attrs.get("data_dir", os.path.join(cls.DATA_DIR, "voc")), attrs["split"],
                                    attrs.get("use_difficult", False))
        if factory != "PapDataset":
            raise KeyError(f"dataset {name!r}: unknown factory {factory!r}")
        return cls._pap_from_disk(attrs)

    @classmethod
    def _pap_from_disk(cls, attrs):
        from PIL import Image

        from .pap import PapDataset, SlideAnnotations

        root = os.path.join(cls.DATA_DIR, "pap", attrs["split"])
        if not os.path.isdir(root):
            raise FileNotFoundError(f"{root} not found: supply real pap data or use synthetic_* datasets")
        slides, anns = [], []
        img_dir = os.path.join(root, "images")
        for fname in sorted(os.listdir(img_dir)):
            slides.append(os.path.join(img_dir, fname))
            mask_dir = os.path.join(root, "masks", os.path.splitext(fname)[0])
            boxes, labels, masks = [], [], []
            if os.path.isdir(mask_dir):
                for mf in sorted(os.listdir(mask_dir)):
                    label = int(os.path.splitext(mf)[0].rsplit("_", 1)[-1])
                    m = np.asarray(Image.open(os.path.join(mask_dir, mf))) > 0
                    ys, xs = np.nonzero(m)
                    if len(ys) == 0:
                        continue
                    boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
                    labels.append(label)
                    masks.append(m)
            anns.append(SlideAnnotations(boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                                         labels=np.asarray(labels, np.int32), masks=masks))
        # the reference filters gt at 0.05 for train/val, 0.005 for test (Pap.py:293, 622)
        cutoff = 0.005 if attrs["split"] == "test" else 0.05
        return PapDataset(
            slides, anns, overlap=attrs.get("overlap", 0.0), is_train=attrs.get("is_train", False),
            train_ratio=attrs.get("train_ratio", 1.0), require_both_classes=attrs.get("require_both_classes", False),
            cache_dir=attrs.get("cache_dir"), area_ratio_cutoff=attrs.get("area_ratio_cutoff", cutoff),
        )


def build_datasets(names):
    """Catalog names -> one dataset, a ``ConcatDataset`` of them where
    several are given (the reference's data/build.py:60-66)."""
    if isinstance(names, str):
        names = (names,)
    datasets = [DatasetCatalog.get(n) for n in names]
    if not datasets:
        raise ValueError("no dataset names given (cfg.DATASETS.* is empty)")
    if len(datasets) == 1:
        return datasets[0]
    from .concat import ConcatDataset

    return ConcatDataset(datasets)
