"""Loading maskrcnn-benchmark ``.pth`` and Caffe2 Detectron ``.pkl``
weights into the port's models (the port's copy of
``mmt_psm_tpu/utils/c2_loading.py:93-197`` and the transfer rule of
``utils/torch_import.py:80-82``, after the reference's
maskrcnn_benchmark/utils/checkpoint.py:148-201 and
c2_model_loading.py:12-155).

The port's ``state_dict`` names are maskrcnn-benchmark's, so a ``.pth``
needs no format conversion: its leading ``module.`` is stripped and its
names are aligned to the model's by suffix (``utils/model_serialization``).
A ``.pkl`` holds Caffe2 blobs, renamed key by key (``rename_c2_key``:
res2_0_branch2a_w -> backbone.body.layer1.0.conv1.weight, ...).

Transfer mode drops every name holding ``cls_score``, ``bbox_pred.`` or
``mask_fcn_logits``, whose shapes follow NUM_CLASSES; as in the JAX
package, ``bbox_pred.`` takes the RPN's ``rpn.head.bbox_pred`` with it.

Nothing is downloaded: a ``catalog://`` name or an ``http`` URL raises and
names the file to pass instead.
"""

from __future__ import annotations

import os
import pickle
import re

import numpy as np
import torch

from .model_serialization import align_by_suffix

# names whose shapes follow NUM_CLASSES; dropped in transfer mode
TRANSFER_SKIP = ("cls_score", "bbox_pred.", "mask_fcn_logits")

# last-block index per stage for the FPN blob names (c2_model_loading.py:_C2_STAGE_NAMES)
_STAGE_LAST_BLOCK = {"R-50": (2, 3, 5, 2), "R-101": (2, 3, 22, 2)}

_RE_STEM = re.compile(r"^conv1_(w|b)$|^res_conv1_bn_(s|b)$")
_RE_BLOCK = re.compile(r"^res(\d)_(\d+)_branch(1|2a|2b|2c)(_bn)?_(w|s|b)$")
_RE_FPN_INNER = re.compile(r"^fpn_inner_res(\d)_(\d+)_sum(_lateral)?_(w|b)$")
_RE_FPN_LAYER = re.compile(r"^fpn_res(\d)_(\d+)_sum_(w|b)$")
_RE_RPN = re.compile(r"^(conv_rpn|rpn_cls_logits|rpn_bbox_pred)(_fpn2)?_(w|b)$")
# head blobs: bare Detectron names -> the reference's module paths
_HEAD_PREFIX = {
    "fc6": "roi_heads.box.feature_extractor.",
    "fc7": "roi_heads.box.feature_extractor.",
    "cls_score": "roi_heads.box.predictor.",
    "bbox_pred": "roi_heads.box.predictor.",
    "conv5_mask": "roi_heads.mask.predictor.",
    "mask_fcn_logits": "roi_heads.mask.predictor.",
}
_RE_HEAD = re.compile(r"^(fc6|fc7|cls_score|bbox_pred|conv5_mask|mask_fcn_logits|mask_fcn\d)_(w|b)$")

_BRANCH2 = {"2a": "conv1", "2b": "conv2", "2c": "conv3"}
_BRANCH2_BN = {"2a": "bn1", "2b": "bn2", "2c": "bn3"}
_LEAF = {"w": "weight", "b": "bias", "s": "weight"}  # a BN scale is its weight


def rename_c2_key(key: str, arch: str = "R-50") -> str | None:
    """One Caffe2 blob name -> the reference's parameter name, or None for
    blobs no module holds (momenta, fc1000). The C2 ``mask_fcn{i}`` blobs
    map to ``roi_heads.mask.feature_extractor.mask_fcn{i}``, which the
    reference's rename never reaches (c2_model_loading.py:89 replaces a
    string that does not occur), as the JAX package maps them."""
    if key.endswith("_momentum") or key.startswith(("pred_", "fc1000")):
        return None
    if _RE_STEM.match(key):
        if key.startswith("conv1"):
            return f"backbone.body.stem.conv1.{_LEAF[key[-1]]}"
        return f"backbone.body.stem.bn1.{_LEAF[key[-1]]}"
    m = _RE_BLOCK.match(key)
    if m:
        stage, block, branch, is_bn, leaf = m.groups()
        if branch == "1":
            mod = "downsample.1" if is_bn else "downsample.0"
        else:
            mod = _BRANCH2_BN[branch] if is_bn else _BRANCH2[branch]
        return f"backbone.body.layer{int(stage) - 1}.{block}.{mod}.{_LEAF[leaf]}"
    m = _RE_FPN_INNER.match(key)
    if m:
        stage, block, lateral, leaf = m.groups()
        idx = int(stage) - 1
        # only the top stage has no "_lateral" suffix (c2_model_loading.py:53-62)
        if int(block) != _STAGE_LAST_BLOCK[arch][idx - 1] or bool(lateral) != (idx < 4):
            return None
        return f"backbone.fpn.fpn_inner{idx}.{_LEAF[leaf]}"
    m = _RE_FPN_LAYER.match(key)
    if m:
        stage, block, leaf = m.groups()
        idx = int(stage) - 1
        if int(block) != _STAGE_LAST_BLOCK[arch][idx - 1]:
            return None
        return f"backbone.fpn.fpn_layer{idx}.{_LEAF[leaf]}"
    m = _RE_RPN.match(key)
    if m:
        name, _, leaf = m.groups()
        mod = {"conv_rpn": "conv", "rpn_cls_logits": "cls_logits", "rpn_bbox_pred": "bbox_pred"}[name]
        return f"rpn.head.{mod}.{_LEAF[leaf]}"
    m = _RE_HEAD.match(key)
    if m:
        name, leaf = m.groups()
        return f"{_HEAD_PREFIX.get(name, 'roi_heads.mask.feature_extractor.')}{name}.{_LEAF[leaf]}"
    return None


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles dicts of numpy arrays and nothing else: a pickle can run
    any callable it names, and a blob file needs only numpy's constructors."""

    _ALLOWED = {("collections", "OrderedDict"), ("numpy", "ndarray"), ("numpy", "dtype")} | {
        (mod, fn) for mod in ("numpy.core.multiarray", "numpy._core.multiarray", "numpy.core.numeric",
                              "numpy._core.numeric")
        for fn in ("_reconstruct", "scalar", "_frombuffer")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a Caffe2 blob file")
        return super().find_class(module, name)


def load_c2_pickle(path: str, arch: str = "R-50") -> dict:
    """A Caffe2 ``.pkl`` -> {reference name: np.ndarray}
    (c2_model_loading.py:120-155)."""
    with open(path, "rb") as f:
        data = _ArrayUnpickler(f, encoding="latin1").load()
    blobs = data.get("blobs", data) if isinstance(data, dict) else data
    out = {}
    for k in sorted(blobs):
        new = rename_c2_key(k, arch)
        if new is not None:
            out[new] = np.asarray(blobs[k])
    return out


def _local(path: str) -> str:
    """``path`` itself; a ``catalog://`` name or a URL raises, naming the
    file that would have been downloaded."""
    if path.startswith(("catalog://", "http://", "https://")):
        name = os.path.basename(path.split("?")[0].rstrip("/"))
        if path.startswith("catalog://"):
            name += ".pkl"  # catalog names are Detectron pickles
        raise FileNotFoundError(f"{path}: nothing is downloaded; pass the path of a local copy of {name}")
    return path


def load_checkpoint_file(path: str, model: torch.nn.Module, transfer: bool = True, arch: str = "R-50") -> dict:
    """Load a ``.pth`` (a maskrcnn-benchmark checkpoint, the weights under
    ``"model"``, or a bare ``state_dict``) or a Caffe2 ``.pkl`` into
    ``model`` in place. A model tensor takes the file's tensor whose name
    ends with the model's whole name (after suffix alignment) and whose
    shape agrees; a name that matches only in part (the box predictor's
    ``bbox_pred.bias`` and the RPN's have one shape) is not taken. Returns
    {"loaded": model names, "missing": model names the file does not hold,
    "mismatched": model names whose file tensor has another shape}."""
    path = _local(path)
    if path.endswith(".pkl"):
        sd = load_c2_pickle(path, arch)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    # strip a leading DataParallel prefix only: a global replace would eat
    # interior names such as relation_nms.relation_module.WG
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    if transfer:
        sd = {k: v for k, v in sd.items() if not any(s in k for s in TRANSFER_SKIP)}
    own = model.state_dict()
    aligned, report = align_by_suffix(own, sd)
    whole = lambda mk, lk: lk == mk or lk.endswith("." + mk)  # noqa: E731
    new, loaded = dict(own), []
    for mk, lk in report["matched"]:
        if whole(mk, lk):
            new[mk] = aligned[mk]
            loaded.append(mk)
    done = set(loaded)
    mismatched = [mk for mk in own if mk not in done and any(whole(mk, lk) for lk in sd)]
    skip = done.union(mismatched)
    missing = [mk for mk in own if mk not in skip]
    model.load_state_dict(new)
    return {"loaded": loaded, "missing": missing, "mismatched": mismatched}
