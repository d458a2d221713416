"""The port's training data path against the JAX package's jax-free data
modules (imported here only): the colour ops, the flip, the eraser, the
jitter and the two training pipelines, the source and unlabeled loaders,
the unlabeled pap split of the catalog, and the training config keys. From the same seeds every array must be identical.
"""

import itertools

import numpy as np
import pytest
import yaml
from PIL import Image

import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.data import catalog as jcat
from mmt_psm_tpu.data import loader as jloader
from mmt_psm_tpu.data import pap as jpap
from mmt_psm_tpu.data import transforms as JT
from mmt_psm_tpu_torch.config import get_cfg, load_yaml
from mmt_psm_tpu_torch.data import catalog as cat
from mmt_psm_tpu_torch.data import loader, pap
from mmt_psm_tpu_torch.data import transforms as T
from test_torch_port_data import assert_same


def sample(seed=0, h=90, w=120):
    """An RGB window with 3 instances: boxes, labels, full-window masks."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[10:40, 20:70] = [250, 30, 30]  # a saturated patch: the hue pass's red branch
    masks = np.zeros((3, h, w), np.uint8)
    boxes = []
    for i in range(3):
        y, x = rng.integers(0, h - 30), rng.integers(0, w - 40)
        masks[i, y : y + 25, x : x + 35] = 1
        boxes.append([x, y, x + 34, y + 24])
    return {"image": img, "boxes": np.asarray(boxes, np.float32), "labels": np.array([1, 2, 1], np.int32),
            "masks": masks}


# name -> call(module, rng): each draws from the same seeded generator
TRANSFORMS = {
    "adjust_brightness": lambda M, r: M.adjust_brightness(sample()["image"], r.uniform(0.5, 1.5)),
    "adjust_contrast": lambda M, r: M.adjust_contrast(sample()["image"], r.uniform(0.5, 1.5)),
    "adjust_gamma": lambda M, r: M.adjust_gamma(sample()["image"], r.uniform(0.5, 2.0), r.uniform(0.8, 1.2)),
    "adjust_saturation": lambda M, r: M.adjust_saturation(sample()["image"], r.uniform(0.0, 2.0)),
    "adjust_hue": lambda M, r: M.adjust_hue(sample()["image"], r.uniform(-0.5, 0.5)),
    "hflip_sample": lambda M, r: M.hflip_sample(sample()),
    "random_erasing": lambda M, r: M.random_erasing(sample()["image"], r, 0.7),
    "color_jitter": lambda M, r: M.color_jitter(sample()["image"], r),
    "source_transform": lambda M, r: M.source_transform(sample(), r, 64, 100),
    "source_transform_square": lambda M, r: M.source_transform(sample(h=96, w=96), r, 128, 128),
    "unlabeled_transform": lambda M, r: M.unlabeled_transform({"image": sample()["image"]}, r, 3, 72, 128),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_transforms_identical(name, seed):
    """Arrays and the generator's state afterwards identical (the draws
    come in the same order)."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    assert_same(TRANSFORMS[name](T, rt), TRANSFORMS[name](JT, rj), name)
    assert rt.bit_generator.state == rj.bit_generator.state


def test_training_loaders_identical():
    """The first 3 batches of the source loader over synthetic slides and of
    the unlabeled loader over their patches (resized 128 -> 96 on a 128
    canvas, so both the resize and the padding run)."""
    kw = dict(seed=3, num_slides=2, slide_size=256, win_size=128, overlap=0.5)
    ours, theirs = pap.synthetic_slide_dataset(**kw), jpap.synthetic_slide_dataset(**kw)
    src = loader.make_source_loader(ours, 2, 128, max_gt=8, min_size=96, max_size=128, seed=5)
    jsrc = jloader.make_source_loader(theirs, 2, 128, max_gt=8, min_size=96, max_size=128, seed=5)
    for i, (a, b) in enumerate(itertools.islice(zip(src, jsrc), 3)):
        assert_same(a, b, f"source batch {i}")
    assert a["image"].shape == (2, 128, 128, 3) and a["masks"].shape == (2, 8, 128, 128)
    patches = [s[:128, :128] for s in ours.slides] + [s[128:, 128:] for s in ours.slides]
    unl = loader.make_unlabeled_loader(pap.PapUnlabeledDataset(patches), 2, 128, 2, 1, 96, 128)
    junl = jloader.make_unlabeled_loader(jpap.PapUnlabeledDataset(patches), 2, 128, 2, 1, 96, 128)
    for i, (a, b) in enumerate(itertools.islice(zip(unl, junl), 3)):
        assert_same(a, b, f"unlabeled batch {i}")
    assert a["t_images"].shape == (2, 2, 128, 128, 3) and a["s_images"].shape == (2, 1, 128, 128, 3)
    assert (a["image_size"] == 96).all()


def test_unlabeled_catalog_split(tmp_path, monkeypatch):
    """papnuclei_no_label builds from DATA_DIR/pap/no_label/*.png as JAX's does."""
    root = tmp_path / "pap" / "no_label"
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for k in range(3):
        Image.fromarray(rng.integers(0, 256, (40 + k, 50, 3), dtype=np.uint8)).save(root / f"p{k}.png")
    (root / "notes.txt").write_text("not a patch")
    monkeypatch.setattr(cat.DatasetCatalog, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jcat.DatasetCatalog, "DATA_DIR", str(tmp_path))
    ours, theirs = cat.build_datasets(("papnuclei_no_label",)), jcat.build_datasets(("papnuclei_no_label",))
    assert isinstance(ours, pap.PapUnlabeledDataset) and len(ours) == len(theirs) == 3
    for i in range(3):
        assert_same(ours[i], theirs[i], f"patch {i}")


def test_training_config_keys_match_jax_defaults():
    """The keys the training loop and CLI read have the JAX defaults; the
    flagship's config round-trips through ``dump`` (the CLI's config.yaml)."""
    ours, theirs = get_cfg(), jax_get_cfg()
    keys = ["INPUT.MIN_SIZE_TRAIN", "DATASETS.TRAIN", "DATASETS.GEN", "DATASETS.NO_LABEL",
            "SOLVER.CHECKPOINT_PERIOD", "SOLVER.IMS_PER_BATCH", "TPU.MESH_SHAPE", "TPU.PROFILE_DIR",
            "TPU.PROFILE_START", "TPU.PROFILE_STEPS"]
    for key in keys:
        a, b = ours, theirs
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, key
    ours.merge_from_file(U.FLAGSHIP)
    text = ours.dump()
    assert load_yaml(text) == yaml.safe_load(text)
    back = get_cfg()
    back.merge_from_dict(load_yaml(text))
    assert back == ours
