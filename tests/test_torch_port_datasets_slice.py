"""The dataset slice of the port end to end on the CPU, against the JAX
package: ``run_inference`` of both packages, the same weights (the flagship
graph at a 128 canvas in float32, ``torch_port_util.build_pair``, 16
proposals an image after the RPN), over a COCO-format split concatenated
with a synthetic one, with overlays (``visual_dir``) and ``.mat`` export
(``mat_dir``) on. The COCO split's windows hold the JAX model's own
instances as gt (RLE, categories 7 and 9), so the stats are not zeros.

The stats meet the serving test's STATS_ATOL (tests/test_torch_port_serving.py
says why). Overlays and label maps rendered from one set of detections
must be identical: the port's engine is also run on a stand-in model that
gives back the JAX model's own detections, and then its files and stats
equal JAX's bit for bit. Last, the port's test CLI and train CLI run over
such a concatenation through the catalog (``coco_*`` plus ``synthetic_*``).
"""

import json
import os

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch
from PIL import Image

import torch_port_datasets as D
import torch_port_util as U
from mmt_psm_tpu.data import catalog as jcat
from mmt_psm_tpu.data import coco as jcoco
from mmt_psm_tpu.data import concat as jconcat
from mmt_psm_tpu.data import loader as jloader
from mmt_psm_tpu.data import pap as jpap
from mmt_psm_tpu.engine import inference as jinf
from mmt_psm_tpu.engine import paste as jpaste
from mmt_psm_tpu_torch.data import catalog as cat
from mmt_psm_tpu_torch.data import coco, concat, loader, pap
from mmt_psm_tpu_torch.engine import inference as inf
from mmt_psm_tpu_torch.evaluation._native import rle_encode
from mmt_psm_tpu_torch.structures.detections import Detections

U.setup_torch()

BATCH, CANVAS, MAX_GT = 4, 128, 16
LOADER = dict(max_gt=MAX_GT, min_size=CANVAS, max_size=CANVAS, raw_u8=True)
STATS_ATOL = 1e-2  # the serving test's
VISUAL_NUM = 2
CATEGORY_IDS = {1: 7, 2: 9}  # label -> the JSON's category id
RESULT_KEYS = {"AJI", "AJI_mean", "mAP", "AP50", "AP75", "AP85", "F1", "images_per_sec"}


@pytest.fixture(scope="module")
def pair():
    jm, params, tm, _ = U.build_pair(fpn_post_nms_top_n_test=16)
    return jm, params, tm


def write_own_instances(root, jm, params):
    """3 windows of a synthetic slide as ``root/images/*.png`` and an
    ``annotations.json`` of the JAX model's pasted instances (every other
    one moved 2 px right), as uncompressed RLE."""
    ds = jpap.synthetic_slide_dataset(seed=5, num_slides=1, slide_size=256, win_size=CANVAS, overlap=0.0,
                                      is_train=False)
    batch = next(jloader.make_test_loader(ds, BATCH, CANVAS, **LOADER))
    boxes, scores, labels, valid, masks, _ = jax.device_get(
        jinf._cached_infer(jm)(params, batch["image"], batch["image_size"]))
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    data = {"images": [], "annotations": [], "categories": [{"id": 7, "name": "cytoplasm"},
                                                             {"id": 9, "name": "nuclei"}]}
    for i in range(3):
        Image.fromarray(batch["image"][i]).save(os.path.join(root, "images", f"w{i}.png"))
        data["images"].append({"id": i + 1, "file_name": f"w{i}.png", "height": CANVAS, "width": CANVAS})
        dt = jpaste.detections_to_instseg(boxes[i], scores[i], labels[i], valid[i], np.asarray(masks[i], np.float32),
                                          (CANVAS, CANVAS))
        for c, inst in sorted(dt.items()):
            for k, (b, m) in enumerate(zip(inst.boxes, inst.masks)):
                full = np.zeros((CANVAS, CANVAS), np.uint8)
                full[b[1] : b[3] + 1, b[0] : b[2] + 1] = m
                if k % 2:
                    full = np.pad(full, ((0, 0), (2, 0)))[:, :CANVAS]
                ys, xs = np.nonzero(full)
                if len(ys) < 4:
                    continue
                data["annotations"].append({
                    "id": len(data["annotations"]) + 1, "image_id": i + 1, "category_id": CATEGORY_IDS[c],
                    "iscrowd": 0, "area": int(len(ys)),
                    "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)],
                    "segmentation": {"size": [CANVAS, CANVAS], "counts": rle_encode(full).tolist()}})
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump(data, f)
    return root


SYNTHETIC = dict(seed=42, num_slides=1, slide_size=256, win_size=CANVAS, overlap=0.0, is_train=False)


@pytest.fixture(scope="module")
def data_root(pair, tmp_path_factory):
    jm, params, _ = pair
    root = tmp_path_factory.mktemp("datasets")
    write_own_instances(str(root / "coco_own"), jm, params)
    return root


def datasets(root):
    """(port, JAX) concatenations: the COCO split, then 4 synthetic windows."""
    ann, img = str(root / "coco_own" / "annotations.json"), str(root / "coco_own" / "images")
    return (concat.ConcatDataset([coco.COCODataset(ann, img), pap.synthetic_slide_dataset(**SYNTHETIC)]),
            jconcat.ConcatDataset([jcoco.COCODataset(ann, img), jpap.synthetic_slide_dataset(**SYNTHETIC)]))


class Replay(torch.nn.Module):
    """A stand-in model whose forwards give back recorded detections, batch
    by batch: the port's engine then renders and scores the JAX model's
    own detections."""

    def __init__(self, outputs, config):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.outputs, self.config = list(outputs), config

    def forward(self, images, sizes):
        return self.outputs.pop(0)


def read_outputs(root):
    """{file name: array} of the overlays (PNG) and label maps (.mat) under root."""
    out = {}
    for d in ("vis", "mat"):
        for f in sorted(os.listdir(root / d)):
            p = str(root / d / f)
            out[f] = np.asarray(Image.open(p)) if f.endswith(".png") else sio.loadmat(p)["predmap"]
    return out


@pytest.fixture(scope="module")
def runs(pair, data_root, tmp_path_factory):
    jm, params, tm = pair
    ours, theirs = datasets(data_root)
    out = {}
    for name, model, ds in (("jax", None, theirs), ("port", tm, ours)):
        d = tmp_path_factory.mktemp(name)
        kw = dict(eval_workers=0, visual_num=VISUAL_NUM, visual_dir=str(d / "vis"), mat_dir=str(d / "mat"))
        batches = (jloader if model is None else loader).make_test_loader(ds, BATCH, CANVAS, **LOADER)
        if model is None:
            stats, timing = jinf.run_inference(jm, params, batches, **kw)
        else:
            stats, timing = inf.run_inference(model, batches, **kw)
        out[name] = (stats, timing, d)
    return out


def test_concatenated_batches_identical(data_root):
    ours, theirs = datasets(data_root)
    assert len(ours) == len(theirs) == 7 and ours.get_idxs(3) == (1, 0)
    got = list(loader.make_test_loader(ours, BATCH, CANVAS, **LOADER))
    want = list(jloader.make_test_loader(theirs, BATCH, CANVAS, **LOADER))
    D.assert_same(got, want)
    assert set(np.concatenate([b["labels"][b["gt_valid"]] for b in got[:1]]).tolist()) == {1, 2}


def test_run_inference_matches_jax(runs):
    (got, g_t, _), (want, w_t, _) = runs["port"], runs["jax"]
    assert g_t["images"] == w_t["images"] == 7
    assert set(got) == set(want)
    for metric in want:
        assert set(got[metric]) == set(want[metric]), metric
        for k, w in want[metric].items():
            assert abs(got[metric][k] - w) <= STATS_ATOL, (metric, k, got[metric][k], w)
    assert got["AJI"][1] > 0 and got["mAP"]["all"] > 0
    assert all(np.isfinite(v) for m in got.values() for v in m.values())


def test_overlays_and_mat_files_written_as_jax_writes_them(runs):
    """The same files: VISUAL_NUM overlays, one label map an image, each the
    image's size; the overlays differ from the raw windows."""
    ours, theirs = read_outputs(runs["port"][2]), read_outputs(runs["jax"][2])
    assert sorted(ours) == sorted(theirs) == ["img_%04d.mat" % i for i in range(7)] + ["vis_0000.png",
                                                                                        "vis_0001.png"]
    for name in ours:
        assert ours[name].shape == theirs[name].shape and ours[name].dtype == theirs[name].dtype, name
    assert ours["vis_0000.png"].shape == (CANVAS, CANVAS, 3) and ours["img_0000.mat"].max() > 0


def test_same_detections_render_and_score_identically(pair, data_root, runs, tmp_path):
    """The JAX model's detections of each batch through the port's engine:
    overlays, label maps and every stat identical to the JAX run's."""
    jm, params, tm = pair
    ours, _ = datasets(data_root)
    recorded = []
    for b in loader.make_test_loader(ours, BATCH, CANVAS, **LOADER):
        boxes, scores, labels, valid, masks, _ = jax.device_get(
            jinf._cached_infer(jm)(params, b["image"], b["image_size"]))
        recorded.append(Detections(boxes=U.t(boxes), scores=U.t(scores), labels=U.t(labels), valid=U.t(valid),
                                   masks=U.t(np.asarray(masks))))
    stats, _ = inf.run_inference(Replay(recorded, tm.config), loader.make_test_loader(ours, BATCH, CANVAS, **LOADER),
                                 eval_workers=0, visual_num=VISUAL_NUM, visual_dir=str(tmp_path / "vis"),
                                 mat_dir=str(tmp_path / "mat"))
    assert stats == runs["jax"][0]
    D.assert_same(read_outputs(tmp_path), read_outputs(runs["jax"][2]))


@pytest.fixture
def catalog_dir(data_root, monkeypatch):
    """The COCO split as ``coco_own`` under both catalogs' DATA_DIR."""
    for c in (cat, jcat):
        monkeypatch.setattr(c.DatasetCatalog, "DATA_DIR", str(data_root))
    return data_root


def test_test_cli_over_a_concatenation(pair, catalog_dir, tmp_path):
    """The port's test CLI resolves ``coco_own`` and ``synthetic_val`` into
    one concatenation, writes result.json with the JAX CLI's keys, the
    overlays and a .mat an image."""
    from mmt_psm_tpu_torch.tools import test_net
    from mmt_psm_tpu_torch.utils.checkpoint import Checkpointer

    _, _, tm = pair
    Checkpointer(str(tmp_path)).save("model_0000001", {"model": tm.state_dict()})
    out = tmp_path / "out"
    opts = U.TRAIN_OPTS + ["MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "16", "TEST.IMS_PER_BATCH", str(BATCH),
                           "TEST.EVAL_WORKERS", "0", "DATASETS.MODE_IN_TEST", "test",
                           "DATASETS.TEST", '("coco_own", "synthetic_val")',
                           "TEST.VISUAL_NUM", "2", "TEST.GEN", "True"]
    results = test_net.main(["--ckpt-dir", str(tmp_path), "--device", "cpu", "--output-dir", str(out), *opts])
    assert set(results["model_0000001"]) == RESULT_KEYS
    with open(out / "result.json") as f:
        assert json.load(f) == results
    n = len(cat.build_datasets(("coco_own", "synthetic_val")))
    assert n == 3 + 8
    assert sorted(os.listdir(out / "vis_model_0000001")) == ["vis_0000.png", "vis_0001.png"]
    assert len(os.listdir(out / "mat_model_0000001")) == n
    assert results["model_0000001"]["AJI"]["1"] > 0


def test_train_cli_over_a_concatenation(catalog_dir, tmp_path):
    """Two supervised iterations of the port's train CLI (START_MT above
    MAX_ITER, no unlabeled split) on ``coco_own`` + ``synthetic_train``:
    every logged loss finite, the student's final checkpoint written."""
    from mmt_psm_tpu_torch.tools import train_mean_teacher

    out = str(tmp_path / "run")
    opts = U.TRAIN_OPTS + ["DATASETS.TRAIN", '("coco_own", "synthetic_train")', "DATASETS.NO_LABEL", "False",
                           "MT.START_MT", "5", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "10"]
    res = train_mean_teacher.main(["--device", "cpu", "--skip-test", "--output-dir", out, *opts])
    loop = res["trainer"]
    assert loop.unlabeled_loader is None and res["final_eval"] is None
    losses = {k: list(m.deque) for k, m in loop.meters.meters.items() if k != "time"}
    assert len(losses["loss_total"]) == 2 and all(np.isfinite(v) for vs in losses.values() for v in vs)
    assert "mt_weight" not in losses
    # no teacher before START_MT, so no t_model_final
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == ["model_final.pth"]


def test_pool_with_rendered_images_keeps_image_order(pair, data_root, runs, tmp_path):
    """With a pool of eval workers, the rendered first image is scored here
    and the others in the workers: the rows keep image order, so every stat
    equals the serial run's."""
    _, _, tm = pair
    ours, _ = datasets(data_root)
    stats, timing = inf.run_inference(tm, loader.make_test_loader(ours, BATCH, CANVAS, **LOADER), eval_workers=2,
                                      visual_num=1, visual_dir=str(tmp_path / "vis"))
    assert timing["pool_start_seconds"] is not None and timing["images"] == 7
    assert os.listdir(tmp_path / "vis") == ["vis_0000.png"]
    assert stats == runs["port"][0]
