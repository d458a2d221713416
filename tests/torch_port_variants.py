"""Shared setup for the parity tests of the model variants
(``mmt_psm_tpu_torch/models/variants.py``) against the JAX package.

``variant_pair(name)`` builds both packages' graph of a variant from the
same config tree (the variant's YAML and overrides, merged into each
package's own defaults), cut to a 128 canvas in float32, with one set of
weights: the port's seeded initialisation with randomised FrozenBN
statistics, exported to the JAX layout. The JAX side checks
the export against its parameter tree without compiling its init, which
at these graphs costs more than the forward.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.models import MaskRCNN as JaxMaskRCNN
from mmt_psm_tpu.models import ModelConfig as JaxModelConfig
from mmt_psm_tpu_torch.models import MaskRCNN, ModelConfig
from mmt_psm_tpu_torch.models.variants import VARIANTS, variant_config

WG_BIAS = 5.0
# JAX's own gradient spread: the largest difference between two of its
# runs, on the image and on NOISE_DRAWS copies with NOISE relative noise.
# With the randomised FrozenBN statistics, a unit whose pre-activation lies
# within float32 noise of a ReLU's kink turns on or off with the summation
# order (the port's one-thread and four-thread runs differ), and one draw
# may miss a kink another finds
NOISE, NOISE_DRAWS = 1e-5, 5
# a 128 canvas in float32, 64 proposals a level and an image at test time,
# 100 detections an image (more than one class's 64 proposals, so that the
# post-processor's top-k ranks both classes), the train counts of
# torch_port_util.TRAIN_SMALL
SMALL = dict(U.SMALL, detections_per_img=100, **U.TRAIN_SMALL)
# the C4 stage-5 head costs ~1.5 GFLOP a RoI: fewer RoIs on both sides
C4_SMALL = dict(pre_nms_top_n_test=48, post_nms_top_n_test=24, fpn_post_nms_top_n_test=24,
                pre_nms_top_n_train=48, post_nms_top_n_train=24, fpn_post_nms_top_n_train=24,
                box_batch_per_image=16, mask_max_pos=4, detections_per_img=8)


def jax_variant_cfg(name: str):
    path, opts = VARIANTS[name]
    cfg = jax_get_cfg()
    if path is not None:
        cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    return cfg


# PRCNN's fusion conv costs ~1.4 GFLOP a RoI: fewer mask RoIs
PRCNN_SMALL = dict(detections_per_img=12, mask_max_pos=4)


def _small(mc, extra):
    fields = dict(SMALL)
    if mc.conv_body == "R-50-C4":
        fields.update(C4_SMALL)
    if mc.mask_extractor == "PRCNNFeatureExtractor":
        fields.update(PRCNN_SMALL)
    fields.update(extra)
    if mc.relation_mask is not None:
        fields["relation_mask"] = dataclasses.replace(mc.relation_mask, compute_dtype="float32")
    return dataclasses.replace(mc, **fields)


def variant_configs(name: str, train: bool = False, **extra):
    """(JAX ModelConfig, port ModelConfig) of variant ``name`` at the small size."""
    jm = JaxModelConfig.from_cfg(jax_variant_cfg(name), train=train)
    tm = ModelConfig.from_cfg(variant_config(name), train=train)
    return _small(jm, extra), _small(tm, extra)


def to_jax_flat(model, pooled_chw) -> dict:
    """The port model's tensors as the JAX package's flat param map (the
    inverse of ``load_jax_params``'s layout changes)."""
    from mmt_psm_tpu_torch.utils.jax_params import flax_key

    out = {}
    for name, t in model.state_dict().items():
        key, kind = flax_key(name)
        v = t.detach().numpy()
        if kind in ("bn", "raw") or key.endswith(".bias"):
            pass
        elif kind == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif kind == "deconv":
            v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif kind == "linear":
            v = v.T
        else:  # linear_chw: the torch input axis runs over (C, H, W), JAX's over (H, W, C)
            c, h, w = pooled_chw
            v = v.reshape(-1, c, h, w).transpose(0, 2, 3, 1).reshape(v.shape[0], -1).T
        out[key] = np.ascontiguousarray(v, np.float32)
    return out


def variant_pair(name: str, seed: int = 0, train: bool = False, **extra):
    """-> (jax model, jax params, port model, flat params) of one set of
    weights of variant ``name`` (``pair_of``)."""
    return pair_of(*variant_configs(name, train=train, **extra), seed=seed)


def pair_of(jc, tc, seed: int = 0):
    """-> (jax model, jax params, port model, flat params) of the graphs of
    ``jc`` and ``tc``, one set of weights: the port's seeded initialisation
    (the JAX initialisers' scales) with the FrozenBN statistics randomised,
    its tensors exported in the JAX layout and checked against the JAX
    model's parameter tree (``jax.eval_shape`` of its init: nothing
    compiles)."""
    jmodel = JaxMaskRCNN(config=jc)
    tmodel = MaskRCNN(tc).init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for n, b in tmodel.named_buffers():
            leaf = n.rsplit(".", 1)[-1]
            if leaf in ("weight", "bias", "running_mean", "running_var"):  # FrozenBN statistics
                b.copy_(torch.from_numpy({
                    "weight": rng.uniform(0.5, 1.5, b.shape),
                    "bias": rng.normal(0.0, 0.1, b.shape),
                    "running_mean": rng.normal(0.0, 0.1, b.shape),
                    "running_var": rng.uniform(0.5, 2.0, b.shape),
                }[leaf].astype(np.float32)))
        if tc.with_relation_nms and not tc.rpn_only:
            # the relation head's geometric gate log(max(relu(WG(pos)), 1e-6))
            # has a pole at 0: near it float32 noise changes the attention
            # (test_torch_port_train_step.py); a bias of 5 keeps every gate off it
            tmodel.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
    pooled_chw = (tc.backbone_out_channels, tc.box_pooler_resolution, tc.box_pooler_resolution)
    flat = to_jax_flat(tmodel, pooled_chw)
    size = jc.image_size
    if jc.with_hint_adaptor:  # the MGD adaptor is reached by init_all only, a training forward
        b = U.train_batch(size=size)
        args, kw = (jnp.asarray(b["image"]), jnp.asarray(b["image_size"]), U.jax_gt(b)), {"method": "init_all"}
    else:
        args, kw = tuple(jnp.asarray(a) for a in U.inputs(size=size)), {"train": False}
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
                                                  "dropout": jax.random.PRNGKey(2)}, *args, **kw))
    want = {"/".join(str(getattr(k, "key", k)) for k in path[:-1]) + "." + str(path[-1].key): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    diff = sorted((k, got.get(k), want.get(k)) for k in set(got) | set(want) if got.get(k) != want.get(k))
    assert not diff, diff[:10]
    return jmodel, {"params": U.unflatten(flat)}, tmodel, flat


def jax_forward_test(jm, params):
    images, sizes = U.inputs()
    return jax.jit(lambda p, i, s: jm.apply(p, i, s, train=False))(params, images, sizes)


def port_forward_test(tm):
    images, sizes = U.inputs()
    return tm(torch.from_numpy(images), torch.from_numpy(sizes))


def assert_detections_match(got, want):
    """valid, labels (and head_ids) identical; boxes, scores and mask
    probabilities within 5e-3 (test_torch_port_e2e.py's bounds)."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.head_ids is None) == (want.head_ids is None)
    if got.head_ids is not None:
        np.testing.assert_array_equal(got.head_ids.numpy(), np.asarray(want.head_ids))
    assert (got.masks is None) == (want.masks is None)
    for name in ("boxes", "scores", "masks"):
        g = getattr(got, name)
        if g is not None:
            assert torch.isfinite(g).all(), name
            U.assert_close(g, getattr(want, name), atol=5e-3, what=name)
    assert int(got.valid.sum()) > 0


def train_run(jm, params, tm, batch_seed: int = 0):
    """Both packages' supervised losses and gradients on one batch with the
    same sampler draws; JAX's gradients also on the images with NOISE
    relative noise, NOISE_DRAWS draws (its own spread). Call inside
    ``U.same_draws``."""
    batch = U.train_batch(batch_seed)
    gt = U.jax_gt(batch)

    def loss_fn(p, image):
        losses = jm.apply({"params": p}, image, jnp.asarray(batch["image_size"]), gt, train=True,
                          rngs={"sample": jax.random.PRNGKey(0)})
        return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, j_losses), j_grads = grad_fn(params["params"], batch["image"])
    as_np = lambda g: U.flatten(jax.tree_util.tree_map(np.asarray, g))  # noqa: E731
    j_noisy = []
    for seed in range(1, 1 + NOISE_DRAWS):
        noisy = batch["image"] * (1 + NOISE * np.random.default_rng(seed).standard_normal(batch["image"].shape))
        j_noisy.append(as_np(grad_fn(params["params"], noisy.astype(np.float32))[1]))
    tm.train()
    losses = tm.forward_train(U.t(batch["image"]), U.t(batch["image_size"]), U.torch_gt(batch), torch.Generator())
    sum(losses.values()).backward()
    return {"j_losses": {k: float(v) for k, v in j_losses.items()}, "losses": losses,
            "j_grads": as_np(j_grads), "j_noisy": j_noisy}


def assert_losses_match(run):
    got, want = run["losses"], run["j_losses"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.isfinite(w), k
        U.assert_close(got[k].detach(), w, atol=0.0, rtol=1e-4, what=k)


def assert_grads_match(tm, run, pooled_chw=(256, 7, 7)):
    """Every trainable parameter's gradient within 1e-3 of its largest
    |JAX gradient| + 1e-6, or within JAX's own spread where that is larger:
    the largest difference between any two of JAX's runs, on the image and
    on NOISE_DRAWS noisy copies of it. Returns the names held by the spread."""
    by_spread, n = [], 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            continue
        want = U.port_grad_of(name, run["j_grads"], pooled_chw)
        runs = [want] + [U.port_grad_of(name, g, pooled_chw) for g in run["j_noisy"]]
        spread = max(float(np.abs(a - b).max()) for i, a in enumerate(runs) for b in runs[i + 1:])
        strict = 1e-3 * float(np.abs(want).max())
        # a parameter the losses do not reach has no gradient, and JAX's is 0
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert p.grad is not None or not np.any(want), name
        U.assert_close(grad, want, atol=max(strict, spread) + 1e-6, what=name)
        if float(np.abs(grad.numpy() - want).max()) > strict + 1e-6:
            by_spread.append(name)
        n += 1
    assert n > 50
    return by_spread
