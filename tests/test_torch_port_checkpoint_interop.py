"""Checkpoint interop of the port (``utils/model_serialization.py``,
``utils/c2_loading.py``) against the JAX package's
(``mmt_psm_tpu/utils/{model_serialization,c2_loading,torch_import}.py``)
on the CPU: suffix alignment, the Caffe2 key rename over the R-50 and R-101
key spaces, and transfer loading of a maskrcnn-benchmark ``.pth`` and a
Caffe2 ``.pkl`` written from a random port model. JAX loads a file into its
parameter tree, which ``utils/jax_params.load_jax_params`` carries into a
port model; the port loads the same file directly. The two models must be
identical.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.utils import c2_loading as jc2
from mmt_psm_tpu.utils import model_serialization as jms
from mmt_psm_tpu.utils.torch_import import convert_state_dict
from mmt_psm_tpu_torch.models.detector import load_config, model_from_cfg
from mmt_psm_tpu_torch.utils import c2_loading as c2
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params
from mmt_psm_tpu_torch.utils.model_serialization import align_by_suffix

U.setup_torch()

BLOCKS = {"R-50": {2: 3, 3: 4, 4: 6, 5: 3}, "R-101": {2: 3, 3: 4, 4: 23, 5: 3}}


def model(seed):
    return model_from_cfg(load_config(U.FLAGSHIP, ["TPU.IMAGE_SIZE", 128]), "cpu", seed)


@pytest.fixture(scope="module")
def source():
    """The random port model whose weights the files hold."""
    return model(0).state_dict()


def c2_keys(arch):
    """The Caffe2 blob names of an R-50/R-101 FPN Mask R-CNN, with momenta,
    the ImageNet head, FPN blobs of the wrong block and unknown blobs that
    must map to nothing."""
    keys = ["conv1_w", "conv1_b", "res_conv1_bn_s", "res_conv1_bn_b", "conv1_momentum", "fc1000_w", "pred_b",
            "unknown_blob_w"]
    for s, n in BLOCKS[arch].items():
        for b in range(n):
            for br in ("2a", "2b", "2c") + (("1",) if b == 0 else ()):
                keys += [f"res{s}_{b}_branch{br}_w", f"res{s}_{b}_branch{br}_bn_s", f"res{s}_{b}_branch{br}_bn_b",
                         f"res{s}_{b}_branch{br}_w_momentum"]
        lateral = "" if s == 5 else "_lateral"
        for blk in (n - 1, 0):  # the last block is the real one
            keys += [f"fpn_inner_res{s}_{blk}_sum{lateral}_w", f"fpn_inner_res{s}_{blk}_sum{lateral}_b",
                     f"fpn_res{s}_{blk}_sum_w", f"fpn_res{s}_{blk}_sum_b"]
        keys += [f"fpn_inner_res{s}_{n - 1}_sum{'_lateral' if s == 5 else ''}_w"]  # the wrong suffix for s
    for name in ("conv_rpn", "rpn_cls_logits", "rpn_bbox_pred"):
        keys += [f"{name}_fpn2_w", f"{name}_fpn2_b", f"{name}_w", f"{name}_b"]
    for name in ("fc6", "fc7", "cls_score", "bbox_pred", "mask_fcn1", "mask_fcn2", "mask_fcn3", "mask_fcn4",
                 "conv5_mask", "mask_fcn_logits"):
        keys += [f"{name}_w", f"{name}_b"]
    return keys


@pytest.mark.parametrize("arch", list(BLOCKS))
def test_rename_c2_key_matches_jax(arch):
    keys = c2_keys(arch)
    ours = {k: c2.rename_c2_key(k, arch) for k in keys}
    assert ours == {k: jc2.rename_c2_key(k, arch) for k in keys}
    assert sum(v is not None for v in ours.values()) > 150
    # kept divergence from the reference (tests/test_c2_loading.py:95-99): the
    # reference's rename drops the C2 mask_fcn blobs, the JAX package and the
    # port map them
    assert ours["mask_fcn1_w"] == "roi_heads.mask.feature_extractor.mask_fcn1.weight"
    assert ours["conv1_momentum"] is None and ours["fc1000_w"] is None


def test_align_by_suffix_matches_jax(source):
    """Loaded names under ``module.`` and ``student.`` prefixes, one tensor
    of another shape and one absent: the port's pairs, skips and values are
    JAX's on the same maps (JAX's model names separated by "/")."""
    rng = np.random.default_rng(0)
    names = list(source)
    loaded = {}
    for i, k in enumerate(names[:-1]):
        shape = tuple(source[k].shape)
        if i == 7:
            shape = shape + (2,)
        loaded[("module." if i % 2 else "student.") + k] = rng.normal(size=shape).astype(np.float32)
    ours, rep = align_by_suffix(source, loaded)
    jflat = {k.replace(".", "/"): v.numpy() for k, v in source.items()}
    theirs, jrep = jms.align_by_suffix(jflat, loaded)
    assert rep["matched"] == [(m.replace("/", "."), lk) for m, lk in jrep["matched"]]
    assert rep["skipped"] == [m.replace("/", ".") for m in jrep["skipped"]]
    assert set(rep["skipped"]) == {names[7], names[-1]}
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k.replace(".", "/")], err_msg=k)


def write_pth(path, sd, drop=()):
    torch.save({"model": {f"module.{k}": v for k, v in sd.items() if k not in drop}, "iteration": 90000}, path)


def write_pkl(path, sd):
    """A Caffe2 blob file of the R-50 key space holding ``sd``'s tensors."""
    blobs = {}
    for k in c2_keys("R-50"):
        name = c2.rename_c2_key(k, "R-50")
        blobs[k] = sd[name].numpy() if name in sd else np.zeros((1,), np.float32)
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)


CASES = {
    # transfer mode: the class-count heads (and, by the "bbox_pred." rule,
    # the RPN's bbox_pred) keep their initial weights
    "pth_transfer": (write_pth, True, ()),
    # the box predictor's bbox_pred left out of the file: the RPN's
    # rpn.head.bbox_pred.bias has its shape and shares a suffix with it, and
    # must not be taken for it
    "pth_without_box_bbox_pred": (write_pth, False, ("roi_heads.box.predictor.bbox_pred.weight",
                                                      "roi_heads.box.predictor.bbox_pred.bias")),
    "pkl_transfer": (write_pkl, True, ()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_checkpoint_file_matches_jax(case, source, tmp_path):
    write, transfer, drop = CASES[case]
    path = str(tmp_path / ("w.pkl" if write is write_pkl else "w.pth"))
    write(path, source, drop) if write is write_pth else write(path, source)
    init = model(1)
    start = {k: v.clone() for k, v in init.state_dict().items()}
    # JAX: the file into the JAX parameter tree of the initial weights, then
    # carried into a port model
    flat = {k: v for k, v in convert_state_dict({k: v.numpy() for k, v in start.items()}).items()
            if k != "__unmatched__"}
    params, jrep = jc2.load_checkpoint_file(path, U.unflatten(flat), transfer=transfer, arch="R-50")
    via_jax = model(2)
    load_jax_params(via_jax, U.flatten(params))
    report = c2.load_checkpoint_file(path, init, transfer=transfer)
    got, want = init.state_dict(), via_jax.state_dict()
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]
    assert len(report["loaded"]) == len(jrep["loaded"]) and not report["mismatched"]
    for k in got:
        taken = k in report["loaded"]
        assert torch.equal(got[k], source[k] if taken else start[k]), k
    if transfer:
        assert {k for k in report["missing"] if "cls_score" in k or "bbox_pred" in k} == {
            "roi_heads.box.predictor.cls_score.weight", "roi_heads.box.predictor.cls_score.bias",
            "roi_heads.box.predictor.bbox_pred.weight", "roi_heads.box.predictor.bbox_pred.bias",
            "rpn.head.bbox_pred.weight", "rpn.head.bbox_pred.bias"}
    else:
        assert set(drop) <= set(report["missing"]) and "rpn.head.bbox_pred.bias" in report["loaded"]
    if write is write_pkl:
        # C2 files hold no FrozenBN statistics; the mask head's convs load
        assert "backbone.body.layer1.0.bn1.running_mean" in report["missing"]
        assert "roi_heads.mask.feature_extractor.mask_fcn1.weight" in report["loaded"]


@pytest.mark.parametrize("path", ["catalog://ImageNetPretrained/MSRA/R-50",
                                  "https://example.invalid/models/e2e_mask_rcnn_R_50_FPN_1x.pth"])
def test_remote_weights_raise_naming_the_file(path):
    with pytest.raises(FileNotFoundError, match=r"nothing is downloaded.*(R-50\.pkl|R_50_FPN_1x\.pth)"):
        c2.load_checkpoint_file(path, torch.nn.Linear(1, 1))
