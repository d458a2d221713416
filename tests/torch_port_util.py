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


def configs(dtype: str = "float32", **extra):
    """(JAX ModelConfig, port ModelConfig) of the flagship YAML, cut to SMALL
    (``extra`` fields, e.g. TRAIN_SMALL, added or put in its place), both
    computing in ``dtype`` (the mask relation module too)."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(FLAGSHIP)
    jm = JaxModelConfig.from_cfg(jcfg, train=False)
    jm = dataclasses.replace(jm, **{**SMALL, "compute_dtype": dtype, **extra},
                             relation_mask=dataclasses.replace(jm.relation_mask, compute_dtype=dtype))
    tcfg = get_cfg()
    tcfg.merge_from_file(FLAGSHIP)
    tm = ModelConfig.from_cfg(tcfg)
    tm = dataclasses.replace(tm, **{**SMALL, "compute_dtype": dtype, **extra},
                             relation_mask=dataclasses.replace(tm.relation_mask, compute_dtype=dtype))
    return jm, tm


def inputs(seed: int = 0, batch: int = 2, size: int = 128):
    rng = np.random.default_rng(seed)
    images = rng.normal(0.0, 40.0, (batch, size, size, 3)).astype(np.float32)
    sizes = np.array([[size, size]] + [[size - 8 * i, size - 20 * i] for i in range(1, batch)], np.int32)
    return images, sizes


def build_pair(seed: int = 0, dtype: str = "float32", **extra):
    """-> (jax model, jax params, port model, flat params) sharing one set of
    weights, both computing in ``dtype``."""
    jm, tm = configs(dtype, **extra)
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
    if jm.with_hint_adaptor:
        # the forward_test init does not reach the MGD adaptor: its weights
        # at the flax initialiser's scale, and a bias that is not 0
        limit = (3.0 / 3.0 / jm.backbone_out_channels) ** 0.5
        for i in range(1, len(jm.anchor_strides) + 1):
            flat[f"hint_adaptor/adapter_{i}.kernel"] = rng.uniform(
                -limit, limit, (1, 1, jm.backbone_out_channels, jm.hint_dim)).astype(np.float32)
            flat[f"hint_adaptor/adapter_{i}.bias"] = rng.normal(0.0, 0.05, jm.hint_dim).astype(np.float32)
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


# ------------------------------------------------------------------ training
# the supervised step's counts cut as the inference ones are: 64 proposals
# per level and per batch, 64 sampled RoIs per image, 16 mask RoIs, 8 gt rows;
# no dropout, so both packages compute the same function
TRAIN_SMALL = dict(pre_nms_top_n_train=64, post_nms_top_n_train=64, fpn_post_nms_top_n_train=64,
                   box_batch_per_image=64, mask_max_pos=16, box_head_dropout=0.0)
MAX_GT = 8


def train_batch(seed: int = 0, batch: int = 2, size: int = 128):
    """A synthetic batch (the port's copy of the data generator) as numpy,
    the image normalized as the train step takes it."""
    from mmt_psm_tpu_torch.data.synthetic import generate_batch, normalize_image

    b = generate_batch(seed, batch, image_size=size, max_instances=MAX_GT)
    b["image"] = normalize_image(b["image"])
    return b


def jax_gt(batch):
    from mmt_psm_tpu.structures.detections import GroundTruth

    return GroundTruth(boxes=jnp.asarray(batch["boxes"]), labels=jnp.asarray(batch["labels"]),
                       valid=jnp.asarray(batch["gt_valid"]), masks=jnp.asarray(batch["masks"]))


def torch_gt(batch):
    from mmt_psm_tpu_torch.structures import GroundTruth

    return GroundTruth(boxes=t(batch["boxes"]), labels=t(batch["labels"]), valid=t(batch["gt_valid"]),
                       masks=t(batch["masks"]))


def _sample_with_draws(r, labels, batch_size: int, positive_fraction: float):
    """The body of ``mmt_psm_tpu.ops.sampler.sample`` with its uniform draws
    ``r`` given instead of drawn from a key."""
    n = labels.shape[0]
    is_pos, is_neg = labels >= 1, labels == 0
    pos_order = jnp.argsort(jnp.where(is_pos, r, 2.0))
    neg_order = jnp.argsort(jnp.where(is_neg, r, 2.0))
    max_pos = int(batch_size * positive_fraction)
    num_pos = jnp.minimum(jnp.sum(is_pos), max_pos)
    num_neg = jnp.minimum(jnp.sum(is_neg), batch_size - num_pos)
    slot = jnp.arange(batch_size)
    take_pos = slot < num_pos
    idx = jnp.where(take_pos, pos_order[jnp.clip(slot, 0, n - 1)],
                    neg_order[jnp.clip(slot - num_pos, 0, n - 1)]).astype(jnp.int32)
    valid = slot < (num_pos + num_neg)
    return idx, take_pos & valid, valid


class _IndexKeys:
    """Stands in for the ``jax`` module inside the JAX rpn and box_head
    modules: ``jax.random.split(key, n)`` gives image i the key (i, i), so
    the replaced sampler knows which image's draws to take."""

    class random:
        @staticmethod
        def split(key, n):
            i = jnp.arange(n, dtype=jnp.uint32)
            return jnp.stack([i, i], 1)

    def __getattr__(self, name):
        return getattr(jax, name)


def same_draws(mp, batch: int, seed: int = 0):
    """Make both packages' samplers take the same uniform draws.

    ``mp`` is a ``pytest.MonkeyPatch``. The draws of a batch of ``batch``
    images with n candidates each (the RPN's anchors, the box head's
    proposals) are one numpy table made from (``seed``, n). The port's
    draws come from ``ops.sampler.uniform``; the JAX ``sample`` is replaced
    by one that reads the same table."""
    from mmt_psm_tpu.models import box_head as jbh
    from mmt_psm_tpu.models import rpn as jrpn
    from mmt_psm_tpu_torch.ops import sampler

    def table(n):
        return np.random.default_rng([seed, n]).uniform(size=(batch, n)).astype(np.float32)

    def port_uniform(gen, shape, device):
        assert tuple(shape)[0] == batch, shape
        return torch.from_numpy(table(shape[-1])).to(device)

    def jax_sample(key, labels, batch_size, positive_fraction):
        r = jnp.asarray(table(labels.shape[0]))[key[0]]
        return _sample_with_draws(r, labels, batch_size, positive_fraction)

    mp.setattr(sampler, "uniform", port_uniform)
    for mod in (jrpn, jbh):
        mp.setattr(mod, "sample", jax_sample)
        mp.setattr(mod, "jax", _IndexKeys())


def port_grad_of(name: str, flat_grads, pooled_chw=(256, 7, 7)):
    """The JAX gradient of the port tensor ``name`` in the port's layout."""
    from mmt_psm_tpu_torch.utils.jax_params import _to_torch_layout, flax_key

    key, kind = flax_key(name)
    return np.array(_to_torch_layout(kind, key, np.asarray(flat_grads[key]), pooled_chw))


# yacs overrides that cut the flagship's training run to the CPU tests'
# size: a 128 canvas in float32, one image a batch, 64 proposals and sampled
# RoIs, 8 gt rows, relation-NMS over the first 16 boxes of a class (32
# detections an image, the teacher's pseudo-labels among them)
TRAIN_OPTS = ["TPU.IMAGE_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32", "TPU.MAX_GT", "8",
              "SOLVER.IMS_PER_BATCH", "1", "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "64",
              "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "64", "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "64",
              "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
              "MODEL.RPN.POST_NMS_TOP_N_TEST", "64", "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "64",
              "MODEL.RELATION_NMS.FIRST_N", "16", "MODEL.RELATION_NMS.TOPK", "16"]
