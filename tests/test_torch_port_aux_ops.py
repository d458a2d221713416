"""The port's ``ops/roi_pool.py`` and ``ops/grad_ops.py`` against the JAX
package's on the CPU. ROIPool: the forward identical on RoIs inside, across
and outside the map, with empty bins, at several scales and sizes; its
gradient within 1e-6, on features quantized so that bins hold tied maxima
(JAX's ``jnp.max`` splits a tie evenly, as the port's ``amax`` does).
The gradient reversal: identity forward, -scale * g backward, identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.ops import grad_ops as jgrad
from mmt_psm_tpu.ops import roi_pool as jrp
from mmt_psm_tpu_torch.ops import grad_ops, roi_pool

U.setup_torch()


def _case(seed, h=20, w=24, c=3, n=11, ties=False):
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    if ties:
        feat = np.round(feat * 2) / 2  # a few levels: equal maxima in most bins
    xy = rng.uniform(-20, 90, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(-4, 60, (n, 2))], 1).astype(np.float32)
    rois[0] = [8.0, 8.0, 8.0, 8.0]  # one pixel: most bins empty
    rois[1] = [-40.0, -40.0, -10.0, -12.0]  # outside the map
    rois[2] = [2.0, 6.0, 90.0, 70.0]  # the whole map
    return feat, rois


@pytest.mark.parametrize("scale,pooled", [(0.25, 7), (0.125, 2), (0.5, 4)])
@pytest.mark.parametrize("seed", range(2))
def test_roi_pool_forward_identical(seed, scale, pooled):
    feat, rois = _case(seed, n=40)  # more than one chunk of 32
    got = roi_pool.roi_pool(U.t(feat), U.t(rois), scale, pooled)
    want = np.asarray(jrp.roi_pool(jnp.asarray(feat), jnp.asarray(rois), scale, pooled))
    assert got.shape == (40, pooled, pooled, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want != 0).any()  # empty bins and pooled ones


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_roi_pool_gradient_matches_jax(seed, ties):
    feat, rois = _case(seed, ties=ties)
    cot = np.random.default_rng(seed + 10).normal(0, 1, (len(rois), 5, 5, 3)).astype(np.float32)

    def jfn(f):
        return jnp.sum(jrp.roi_pool(f, jnp.asarray(rois), 0.25, 5) * cot)

    want = np.asarray(jax.grad(jfn)(jnp.asarray(feat)))
    f = U.t(feat).requires_grad_(True)
    (roi_pool.roi_pool(f, U.t(rois), 0.25, 5) * U.t(cot)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=1e-6)
    if ties:  # a tie's gradient is split: values that no single cotangent element has
        assert not np.isin(np.abs(want[want != 0]), np.abs(cot)).all()


def test_roi_pool_without_rois():
    out = roi_pool.roi_pool(torch.zeros(8, 8, 4), torch.zeros(0, 4), 0.5, 3)
    assert out.shape == (0, 3, 3, 4)


@pytest.mark.parametrize("scale", [1.0, 0.1, 2.5])
def test_gradient_reversal_identical(scale):
    rng = np.random.default_rng(0)
    x, g = rng.normal(0, 1, (4, 5)).astype(np.float32), rng.normal(0, 1, (4, 5)).astype(np.float32)
    xt = U.t(x).requires_grad_(True)
    y = grad_ops.gradient_reversal(xt, scale)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (y * U.t(g)).sum().backward()
    _, vjp = jax.vjp(lambda v: jgrad.gradient_reversal(v, scale), jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), -np.float32(scale) * g)
