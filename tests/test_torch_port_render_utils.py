"""The port's host utilities against the JAX package's on the CPU: the
segmentation conversions (``utils/segms.py``, OpenCV's contours), prediction
overlays and instance label maps (``utils/visual.py``), ``.mat`` export
(``utils/mat_output.py``, read back by ``scipy.io.loadmat``), the device
paste ``ops/paste.py::paste_masks``, the environment report, the webcam
tool (a stub ``cv2`` that yields 3 frames) and the Cityscapes converter
(its JSON equal to the JAX converter's). The same inputs from a seed;
every array identical.
"""

import importlib.util
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

import torch_port_datasets as D
import torch_port_util as U
from mmt_psm_tpu.engine import paste as jpaste
from mmt_psm_tpu.ops import paste as jops_paste
from mmt_psm_tpu.utils import mat_output as jmat
from mmt_psm_tpu.utils import segms as jsegms
from mmt_psm_tpu.utils import visual as jvisual
from mmt_psm_tpu_torch.engine import paste
from mmt_psm_tpu_torch.ops import paste as ops_paste
from mmt_psm_tpu_torch.utils import env, mat_output, segms, visual

U.setup_torch()


def _instances(seed, h=48, w=64, k=6):
    """Random blobs as an instance-id image: 0 background, class id * 1000
    + index for 24 (person) and 26 (car), 7 a stuff class."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.int32)
    img[rng.integers(0, h), :] = 7
    for i in range(k):
        m, _ = D._blob(rng, h, w)
        img[m.astype(bool)] = (24 if i % 2 else 26) * 1000 + i
    return img


@pytest.mark.parametrize("seed", range(3))
def test_segms_conversions_identical(seed):
    img = _instances(seed)
    names = {24: "person", 26: "car"}
    got, want = segms.instances_to_dict_with_polygons(img, names), jsegms.instances_to_dict_with_polygons(img, names)
    D.assert_same(got, want)
    assert set(got) == {"person", "car"}
    for objs in got.values():
        for o in objs:
            mask = img == o["id"]
            D.assert_same(segms.mask_to_polygons(mask), jsegms.mask_to_polygons(mask))
            D.assert_same(segms.polys_to_mask(o["contours"], *img.shape),
                          jsegms.polys_to_mask(o["contours"], *img.shape))
            D.assert_same(segms.polys_to_boxes([o["contours"]]), jsegms.polys_to_boxes([o["contours"]]))
            rle = segms.mask_to_rle(mask)
            assert rle == jsegms.mask_to_rle(mask)
            D.assert_same(segms.rle_to_mask(rle), jsegms.rle_to_mask(rle))
            np.testing.assert_array_equal(segms.rle_to_mask(rle), mask)


def test_mask_to_polygons_needs_cv2(monkeypatch):
    """No substitute where OpenCV is missing: the import error names it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        segms.mask_to_polygons(np.ones((4, 4), bool))


def _detections(seed, h=40, w=52, k=8):
    """An image and one set of padded detections with 28 x 28 probabilities."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [w - 12, h - 12], (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 12, (k, 2))], 1).astype(np.float32)
    yy, xx = np.mgrid[:28, :28]
    probs = np.clip((((yy - 13.5) / 11) ** 2 + ((xx - 13.5) / 11) ** 2 <= 1)[None] * 0.8
                    + rng.normal(0, 0.25, (k, 28, 28)), 0, 1).astype(np.float32)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), boxes, rng.uniform(0, 1, k).astype(np.float32),
            rng.integers(1, 3, k).astype(np.int32), rng.random(k) < 0.85, probs)


@pytest.mark.parametrize("seed", range(3))
def test_overlays_and_label_maps_identical(seed):
    img, boxes, scores, labels, valid, probs = _detections(seed)
    hw = img.shape[:2]
    dt = paste.detections_to_instseg(boxes, scores, labels, valid, probs, hw)
    jdt = jpaste.detections_to_instseg(boxes, scores, labels, valid, probs, hw)
    got = visual.overlay_instances(img, {"masks": dt})
    D.assert_same(got, jvisual.overlay_instances(img, {"masks": jdt}))
    assert (got != img).any()
    pred = {"masks": dt, "boxes": boxes[valid], "labels": labels[valid]}
    D.assert_same(visual.overlay_instances(img, pred, alpha=0.3),
                  jvisual.overlay_instances(img, {**pred, "masks": jdt}, alpha=0.3))
    lm = visual.instances_to_label_map(dt, *hw)
    D.assert_same(lm, jvisual.instances_to_label_map(jdt, *hw))
    assert lm.max() == sum(len(v) for v in dt.values()) > 0


def test_mat_output_identical(tmp_path):
    img, boxes, scores, labels, valid, probs = _detections(5)
    hw = img.shape[:2]
    dt = paste.detections_to_instseg(boxes, scores, labels, valid, probs, hw)
    jdt = jpaste.detections_to_instseg(boxes, scores, labels, valid, probs, hw)
    got = mat_output.save_mat_output(dt, *hw, str(tmp_path / "a" / "img.mat"))
    want = jmat.save_mat_output(jdt, *hw, str(tmp_path / "b" / "img.mat"))
    D.assert_same(got, want)
    a, b = sio.loadmat(str(tmp_path / "a" / "img.mat")), sio.loadmat(str(tmp_path / "b" / "img.mat"))
    D.assert_same(a["predmap"], b["predmap"])
    np.testing.assert_array_equal(a["predmap"], got)
    mat_output.save_mat_output(dt, *hw, str(tmp_path / "c.mat"), var_name="inst")
    assert "inst" in sio.loadmat(str(tmp_path / "c.mat"))


@pytest.mark.parametrize("stride", [1.0, 2.0])
def test_paste_masks_identical(stride):
    _, boxes, _, _, valid, probs = _detections(6, k=5)
    got = ops_paste.paste_masks(U.t(probs), U.t(boxes), U.t(valid), 40, stride)
    want = np.asarray(jops_paste.paste_masks(jnp.asarray(probs), jnp.asarray(boxes), jnp.asarray(valid), 40, stride))
    assert got.dtype == torch.float32 and got.shape == (5, 40, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.max()) > 0.5 and not got[~U.t(valid)].any()


def test_collect_env_info_lines():
    """One ``name: version`` line each, as the JAX module writes them; the
    device line names the CPU where there is no card."""
    lines = env.collect_env_info().splitlines()
    assert [ln.split(":", 1)[0] for ln in lines] == ["python", "torch", "devices", "numpy"]
    assert lines[1].startswith(f"torch: {torch.__version__} (CUDA ")
    assert lines[3] == f"numpy: {np.__version__}"
    assert "jax" not in env.collect_env_info()


class _StubCV2(types.ModuleType):
    """``cv2`` for the webcam tool: a camera of ``frames`` random BGR frames,
    windows that record what they show, no key pressed."""

    def __init__(self, frames):
        super().__init__("cv2")
        self.frames, self.shown, self.released, self.closed = list(frames), [], False, False
        stub = self

        class VideoCapture:
            def __init__(self, index):
                self.index = index

            def isOpened(self):
                return True

            def read(self):
                return (True, stub.frames.pop(0)) if stub.frames else (False, None)

            def release(self):
                stub.released = True

        self.VideoCapture = VideoCapture

    def imshow(self, name, image):
        self.shown.append(image)

    def waitKey(self, delay):
        return -1

    def destroyAllWindows(self):
        self.closed = True


def test_webcam_shows_overlays(tmp_path, monkeypatch):
    from mmt_psm_tpu_torch.engine.predictor import CellDemo
    from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg
    from mmt_psm_tpu_torch.tools import webcam
    from mmt_psm_tpu_torch.utils.checkpoint import Checkpointer

    opts = ["TPU.IMAGE_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
            "MODEL.RPN.POST_NMS_TOP_N_TEST", "64", "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "16"]
    model = model_from_cfg(load_config(U.FLAGSHIP, opts), "cpu", seed=3)
    Checkpointer(str(tmp_path)).save("model_final", {"model": model.state_dict()})
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (72, 96, 3), dtype=np.uint8) for _ in range(3)]
    stub = _StubCV2(frames)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    shown = webcam.main(["--ckpt", str(tmp_path / "model_final.pth"), "--device", "cpu", "--min-image-size", "64",
                         "--confidence-threshold", "0.0", *opts])
    assert shown == 3 and len(stub.shown) == 3 and stub.released and stub.closed
    demo = CellDemo(model, min_size=64, confidence_threshold=0.0)
    for frame, image in zip(frames, stub.shown):
        assert image.shape == frame.shape and image.dtype == np.uint8
        np.testing.assert_array_equal(image, demo.run_on_image(frame[..., ::-1])[..., ::-1])


def _write_cityscapes(root, seed):
    from PIL import Image

    city = os.path.join(root, "gtFine", "val", "faketown")
    os.makedirs(city, exist_ok=True)
    for k in range(2):
        stem = f"faketown_00000{k}_000019_"
        with open(os.path.join(city, stem + "gtFine_polygons.json"), "w") as f:
            json.dump({"imgWidth": 64, "imgHeight": 48, "objects": []}, f)
        ids = _instances(seed + k).astype(np.uint16)  # class id * 1000 + index fits 16 bits
        Image.fromarray(ids).save(os.path.join(city, stem + "gtFine_instanceIds.png"))


def test_cityscapes_converter_matches_jax(tmp_path):
    from mmt_psm_tpu_torch.tools import convert_cityscapes_to_coco as conv

    _write_cityscapes(str(tmp_path), seed=7)
    spec = importlib.util.spec_from_file_location(
        "jax_cs_convert", os.path.join(U.REPO, "tools", "cityscapes", "convert_cityscapes_to_coco.py"))
    jconv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jconv)
    conv.main(["--datadir", str(tmp_path), "--outdir", str(tmp_path / "ours")])
    jconv.convert_cityscapes_instance_only(str(tmp_path), str(tmp_path / "theirs"))
    name = "instancesonly_filtered_gtFine_val.json"
    with open(tmp_path / "ours" / name) as f:
        got = json.load(f)
    with open(tmp_path / "theirs" / name) as f:
        want = json.load(f)
    assert got == want
    assert len(got["images"]) == 2 and {c["name"] for c in got["categories"]} == {"person", "car"}
    assert len(got["annotations"]) > 4
    assert sorted(os.listdir(tmp_path / "ours")) == [name]  # train and test have no directory
