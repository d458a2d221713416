"""Suffix-matching state_dict alignment (the port's copy of
``mmt_psm_tpu/utils/model_serialization.py:41-68``, after the reference's
maskrcnn_benchmark/utils/model_serialization.py:10-60).

A checkpoint's names may carry prefixes the model's do not (``module.``,
``student.``): each model name is matched to the loaded name that shares
the most trailing components with it, and the shapes must agree.
"""

from __future__ import annotations

from typing import Dict

import torch


def align_by_suffix(model_sd: Dict[str, torch.Tensor], loaded: Dict[str, object]):
    """For each name of ``model_sd`` (a ``state_dict``), the loaded tensor
    whose name shares the most trailing components with it ("." or "/"
    separated), where the shapes agree; the first such name wins a tie.
    Returns (a copy of ``model_sd`` with those tensors in the model's
    dtypes, {"matched": [(model name, loaded name)], "skipped": [model
    names]})."""
    split = [(lk, lk.replace("/", ".").split(".")) for lk in loaded]
    out = dict(model_sd)
    matched, skipped = [], []
    for mk, mv in model_sd.items():
        a = mk.split(".")
        best, best_len = None, 0
        for lk, b in split:
            n = 0
            while n < min(len(a), len(b)) and a[-1 - n] == b[-1 - n]:
                n += 1
            if n > best_len:
                best, best_len = lk, n
        lv = None if best is None else torch.as_tensor(loaded[best])
        if lv is None or tuple(lv.shape) != tuple(mv.shape):
            skipped.append(mk)
            continue
        out[mk] = lv.to(mv.dtype)
        matched.append((mk, best))
    return out, {"matched": matched, "skipped": skipped}
