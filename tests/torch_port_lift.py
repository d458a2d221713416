"""Shared setup for the parity tests of the learning experiments
(``mmt_psm_tpu_torch/tools/{mt_lift_experiment,synthetic_convergence,
eval_lift_checkpoint,pseudo_label_probe}.py``) against the JAX scripts.

The lift's graph is the plain Mask R-CNN with the greedy post-processor
and the JAX script's ``ModelConfig`` overrides (``LIFT_MODEL``); the JAX
side is built from the same overrides (``lift_configs``), and
``torch_port_variants.pair_of`` gives both one set of weights.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np

import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.models import ModelConfig as JaxModelConfig
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L

SCRIPTS = os.path.join(U.REPO, "scripts")
# the lift's counts cut for a step at a 64 canvas on the CPU
STEP_SMALL = dict(pre_nms_top_n_train=64, post_nms_top_n_train=64, fpn_post_nms_top_n_train=64,
                  box_batch_per_image=32, mask_max_pos=8, pre_nms_top_n_test=64, post_nms_top_n_test=64,
                  fpn_post_nms_top_n_test=64, detections_per_img=16)
# every config key the JAX script's make_cfg sets (scripts/mt_lift_experiment.py:194-230)
ARM_KEYS = {"SOLVER": ("BASE_LR", "MAX_ITER", "STEPS", "WARMUP_ITERS", "IMS_PER_BATCH", "CHECKPOINT_PERIOD"),
            "MT": ("LAMBDA", "FG_HINT", "CLS_LOSS", "SHARPEN", "HARD_NEG", "ALPHA", "START_MT", "RAMPUP_STEP",
                   "RAMPDOWN_STEP", "MAX_ITER", "ODKD")}


def jax_script(name: str):
    """A module of ``scripts/`` imported from its file (the script puts the
    repo root on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lift_configs(size: int, with_hint: bool, dtype: str = "float32", **extra):
    """(JAX ModelConfig, port ModelConfig) of the lift's graph at canvas
    ``size`` in ``dtype``, ``extra`` fields in place of the lift's."""
    jm = JaxModelConfig(image_size=size, with_hint_adaptor=with_hint, **L.LIFT_MODEL)
    tm = L.lift_model_config(size, with_hint)
    fields = {"compute_dtype": dtype, **extra}
    return dataclasses.replace(jm, **fields), dataclasses.replace(tm, **fields)


def jax_init_all(jmodel, size: int) -> dict:
    """The JAX script's ``init_params`` at canvas ``size``: ``init_all`` from
    PRNGKey(0), (1), (2), as a flat map of numpy arrays."""
    b = U.train_batch(0, 2, size)
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    init = jax.jit(lambda r, im, sz, gt: jmodel.init(r, im, sz, gt, method=jmodel.init_all))
    params = init(rngs, jnp.asarray(b["image"]), jnp.asarray(b["image_size"]), U.jax_gt(b))["params"]
    return U.flatten(jax.tree_util.tree_map(np.asarray, params))


def jax_arm_cfg(port_cfg):
    """A JAX config tree with the arm keys of a port arm config."""
    cfg = jax_get_cfg()
    for block, keys in ARM_KEYS.items():
        for k in keys:
            setattr(getattr(cfg, block), k, getattr(getattr(port_cfg, block), k))
    return cfg
