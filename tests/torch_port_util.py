"""Shared setup for the port's parity tests (tests/test_torch_port_*.py).

Builds the flagship graph of both packages at a small size in float32 on
the CPU with the same weights: the JAX model is initialised from a seed,
its FrozenBN statistics and CIAM gamma are randomised (the flax init
leaves them at identity and 0, which would hide the no-eps BN formula
and the attention), and the port loads the result through
``mmt_psm_tpu_torch.utils.jax_params``.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.models import MaskRCNN as JaxMaskRCNN
from mmt_psm_tpu.models import ModelConfig as JaxModelConfig
from mmt_psm_tpu_torch.config import get_cfg
from mmt_psm_tpu_torch.models import MaskRCNN, ModelConfig
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "pap", "mmt_psm_r50_fpn.yaml")
# small proposal counts as in __graft_entry__.dryrun_multichip
SMALL = dict(image_size=128, pre_nms_top_n_test=64, post_nms_top_n_test=64, fpn_post_nms_top_n_test=64,
             compute_dtype="float32")


def setup_torch():
    # tier-1 runs six xdist workers on eight cores
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix) + "." + k] = np.asarray(v)
    return out


def configs():
    """(JAX ModelConfig, port ModelConfig) of the flagship YAML, cut to SMALL."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(FLAGSHIP)
    jm = JaxModelConfig.from_cfg(jcfg, train=False)
    jm = dataclasses.replace(jm, **SMALL, relation_mask=dataclasses.replace(jm.relation_mask, compute_dtype="float32"))
    tcfg = get_cfg()
    tcfg.merge_from_file(FLAGSHIP)
    tm = ModelConfig.from_cfg(tcfg)
    tm = dataclasses.replace(tm, **SMALL, relation_mask=dataclasses.replace(tm.relation_mask, compute_dtype="float32"))
    return jm, tm


def inputs(seed: int = 0, batch: int = 2, size: int = 128):
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 40.0, (batch, size, size, 3)).astype(np.float32)
    sizes = np.array([[size, size]] + [[size - 8 * i, size - 20 * i] for i in range(1, batch)], np.int32)
    return images, sizes


def build_pair(seed: int = 0):
    """-> (jax model, jax params, port model) sharing one set of weights."""
    jm, tm = configs()
    jmodel = JaxMaskRCNN(config=jm)
    images, sizes = inputs()
    params = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(images),
                                         jnp.asarray(sizes), train=False))()
    flat = flatten(jax.tree_util.tree_map(np.asarray, params["params"]))
    rng = np.random.default_rng(seed + 1)
    for k in list(flat):
        if "/bn" in k or "_bn." in k:
            leaf = k.rsplit(".", 1)[1]
            n = flat[k].shape
            flat[k] = {
                "weight": rng.uniform(0.5, 1.5, n),
                "bias": rng.normal(0.0, 0.1, n),
                "running_mean": rng.normal(0.0, 0.1, n),
                "running_var": rng.uniform(0.5, 2.0, n),
            }[leaf].astype(np.float32)
    flat["mask_relation.gamma"] = np.array([0.5], np.float32)
    params = {"params": unflatten(flat)}
    tmodel = MaskRCNN(tm)
    load_jax_params(tmodel, flat)
    return jmodel, params, tmodel, flat


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        path, leaf = key.rsplit(".", 1)
        node = out
        for p in path.split("/"):
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def t(x):
    """JAX/numpy array -> torch CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def assert_close(got, want, atol, rtol=0.0, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bound = atol + rtol * np.abs(want.astype(np.float64))
    worst = float((err - bound).max()) if err.size else 0.0
    assert worst <= 0, f"{what}: max abs err {err.max():.3g} exceeds atol {atol} + rtol {rtol}"
