"""Instance label maps as MATLAB files (the port's copy of
``mmt_psm_tpu/utils/mat_output.py``, after the reference's utils/
get_mat_output.py, which its tools/test_net.py:109-121 calls for the
ISBI2015 export): the per-class instance masks of an image as one
instance-id map, written by ``scipy.io.savemat``.
"""

from __future__ import annotations

import os

from .visual import instances_to_label_map


def save_mat_output(inst_by_cat: dict, h: int, w: int, path: str, var_name: str = "predmap"):
    """Write ``{var_name: label map}`` to ``path``; returns the map."""
    import scipy.io as sio

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    label_map = instances_to_label_map(inst_by_cat, h, w)
    sio.savemat(path, {var_name: label_map})
    return label_map
