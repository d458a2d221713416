"""The mask relation module (``models/mask_relation.py``) against the JAX
package's, module by module: each attention type with each feature
extractor, and SAME_PREDICTOR, on the same inputs and weights, in float32
on the CPU.

Inputs: 2 images of 6 instances (14 x 14 x 256 features, 28 x 28 x 3
logits, one invalid instance and one of label 0 an image); the JAX module
is vmapped over the images as the detector vmaps it. The refined logits
(or the refined maps and the keep mask) within 1e-4 of their largest
|value|; the gradients of a fixed random projection of the output with
respect to every weight and to both inputs within 1e-3 of their largest
|value| + 1e-6 (gamma's sums 600,000 float32 products).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.models.mask_relation import MaskRelationConfig as JCfg
from mmt_psm_tpu.models.mask_relation import MaskRelationRefineNet as JNet
from mmt_psm_tpu_torch.models.mask_relation import EXTRACTORS, MaskRelationConfig, MaskRelationRefineNet
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

U.setup_torch()

B, S, P = 2, 6, 14


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    roi = np.maximum(rng.normal(size=(B, S, P, P, 256)), 0).astype(np.float32)  # after a relu, as the mask head's
    logits = rng.normal(0.0, 3.0, (B, S, 2 * P, 2 * P, 3)).astype(np.float32)
    labels = rng.integers(1, 3, (B, S)).astype(np.int32)
    labels[:, 1] = 0
    valid = np.ones((B, S), bool)
    valid[:, -1] = False
    return roi, logits, labels, valid


CASES = [(t, e, False) for t in ("CIAM", "CAM") for e in EXTRACTORS] + [(t, "SameFeatureMask", True)
                                                                        for t in ("CIAM", "CAM")]


@pytest.mark.parametrize("kind,extractor,same_predictor", CASES)
def test_refine_net_matches_jax(kind, extractor, same_predictor):
    kw = dict(type=kind, extractor=extractor, extractor_channel=8, same_predictor=same_predictor, norm=-1)
    jnet = nn.vmap(JNet, in_axes=0, out_axes=0, variable_axes={"params": None},
                   split_rngs={"params": False})(config=JCfg(**kw))
    roi, logits, labels, valid = _inputs()
    args = tuple(jnp.asarray(a) for a in (roi, logits, labels, valid))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), *args)["params"]
    params = dict(params, gamma=jnp.asarray([0.5], jnp.float32))
    out_shape = jax.eval_shape(lambda: jnet.apply({"params": params}, *args))
    proj = jax.tree_util.tree_map(
        lambda s: np.random.default_rng(1).normal(size=s.shape).astype(np.float32), out_shape)

    def f(p, r, lg):
        out = jnet.apply({"params": p}, r, lg, args[2], args[3])
        return sum(jnp.sum(o.astype(jnp.float32) * w) for o, w in zip(jax.tree_util.tree_leaves(out),
                                                                      jax.tree_util.tree_leaves(proj))), out

    (_, want), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(params, args[0], args[1])

    net = MaskRelationRefineNet(MaskRelationConfig(**kw), 256)
    holder = torch.nn.Module()
    holder.roi_heads = torch.nn.Module()
    holder.roi_heads.mask = torch.nn.Module()
    holder.roi_heads.mask.mask_relation_module = net
    flat = {("mask_relation/" + k if not k.startswith(".") else "mask_relation" + k): v
            for k, v in U.flatten(jax.tree_util.tree_map(np.asarray, params)).items()}
    load_jax_params(holder, flat)
    r, lg = U.t(roi).requires_grad_(), U.t(logits).requires_grad_()
    got = net(r, lg, U.t(labels), U.t(valid))
    if same_predictor:
        # the port's maps come NCHW per instance; JAX's NHWC per image
        maps = got[0].permute(0, 2, 3, 1).reshape(B, S, P, P, -1)
        U.assert_close(maps, want[0], atol=1e-4 * float(np.abs(want[0]).max()), what="maps")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        total = (maps * U.t(proj[0])).sum() + (got[1].float() * U.t(proj[1])).sum()
    else:
        U.assert_close(got, want, atol=1e-4 * float(np.abs(want).max()), what="refined logits")
        # invalid instances and label 0 keep the first-pass logits
        np.testing.assert_array_equal(got[:, -1].detach().numpy(), logits[:, -1])
        np.testing.assert_array_equal(got[:, 1].detach().numpy(), logits[:, 1])
        total = (got * U.t(proj)).sum()
    total.backward()
    jg = U.flatten(jax.tree_util.tree_map(np.asarray, grads[0]))
    jg = {("mask_relation/" + k if not k.startswith(".") else "mask_relation" + k): v for k, v in jg.items()}
    n = 0
    for name, p in net.named_parameters():
        w = U.port_grad_of("roi_heads.mask.mask_relation_module." + name, jg)
        U.assert_close(p.grad, w, atol=1e-3 * float(np.abs(w).max()) + 1e-6, what=name)
        n += 1
    assert n == len(jg)
    for what, g, w in (("roi features", r.grad, grads[1]), ("first-pass logits", lg.grad, grads[2])):
        # an input the variant does not read gets no gradient (JAX: zeros)
        g = torch.zeros(w.shape) if g is None else g
        U.assert_close(g, w, atol=1e-3 * float(np.abs(w).max()) + 1e-6, what=what)
