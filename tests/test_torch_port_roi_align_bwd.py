"""The plain ROIAlign backward (kernel K3's plain version) against the JAX
package's: ``_bwd_dense`` (the linear transpose of the exact full-map
pooler, the primary reference) for any RoI, and the Pallas backward
``_pallas_pool_bwd`` in interpret mode for RoIs inside its 48-cell window.
Mirrors tests/test_roi_align_pallas.py: random cotangents, P = 7 and 14,
clustered and edge boxes, bf16 out. Float32 tolerance 2e-4: sums of up to a
few hundred weighted cotangents per cell, taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.ops.roi_align_pallas import _bwd_dense, _dense_pool, _pallas_pool_bwd
from mmt_psm_tpu_torch.ops.pooler import multilevel_roi_align, multilevel_roi_align_backward_plain

U.setup_torch()

SCALES = (0.25, 0.125, 0.0625, 0.03125)
SHAPES = [(2, 64, 64, 64), (2, 32, 32, 64), (2, 16, 16, 64), (2, 8, 8, 64)]
IMG = 256


def _boxes(rng, n, max_aspect=2.5):
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(10, IMG - 10, 2)
        area = rng.uniform(12, 200) ** 2
        r = rng.uniform(1 / max_aspect, max_aspect)
        w, h = np.sqrt(area * r), np.sqrt(area / r)
        out.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    return np.array(out, np.float32)


def _box_sets(rng, oversize: bool):
    """Image 0: 5 boxes and 5 copies within 3 px (they share cells), two
    boxes over the edge; image 1: 12 random boxes. With ``oversize`` also
    boxes far larger than a 48-cell window of their level."""
    cluster = _boxes(rng, 10)
    cluster[5:] = cluster[:5] + rng.uniform(-3, 3, (5, 4)).astype(np.float32)
    edge = np.array([[-20.0, -20.0, 30.0, 25.0], [IMG - 30.0, IMG - 25.0, IMG + 40.0, IMG + 40.0]], np.float32)
    other = _boxes(rng, 12)
    if oversize:
        other[:2] = [[-60.0, 10.0, 300.0, 40.0], [5.0, -30.0, 20.0, 290.0]]
    return np.stack([np.concatenate([cluster, edge]), other])


@pytest.mark.parametrize("pooled", [7, 14])
@pytest.mark.parametrize("oversize", [False, True])
def test_plain_backward_matches_bwd_dense(pooled, oversize):
    rng = np.random.default_rng(pooled + 10 * oversize)
    boxes = _box_sets(rng, oversize)
    feats = tuple(jnp.zeros(s, jnp.float32) for s in SHAPES)  # only their shapes are read
    g = rng.normal(size=(2, 12, pooled, pooled, 64)).astype(np.float32)
    want = jax.jit(lambda f, b, g: _bwd_dense(SCALES, pooled, 2, (f, b), g))(feats, boxes, g)
    got = multilevel_roi_align_backward_plain(U.t(g), U.t(boxes), SHAPES, SCALES, pooled, 2)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        U.assert_close(a, b, atol=2e-4, what="level gradient")
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1  # the cotangent landed on the maps


@pytest.mark.parametrize("pooled", [7, 14])
def test_plain_backward_matches_pallas_interpret(pooled):
    """RoIs inside the Pallas kernel's window: its read-modify-write
    backward, run by the Pallas interpreter, gives the same gradients."""
    rng = np.random.default_rng(20 + pooled)
    boxes = _box_sets(rng, oversize=False)
    g = rng.normal(size=(2, 12, pooled, pooled, 64)).astype(np.float32)
    want = _pallas_pool_bwd(tuple(SHAPES), (jnp.float32,) * 4, jnp.asarray(boxes), jnp.asarray(g), SCALES, pooled,
                            2, 48, 8, True)
    got = multilevel_roi_align_backward_plain(U.t(g), U.t(boxes), SHAPES, SCALES, pooled, 2)
    for a, b in zip(got, want):
        U.assert_close(a, b, atol=2e-4, what="level gradient")


def test_plain_backward_bf16():
    """A bf16 cotangent gives bf16 gradients: the float32 sum rounded once,
    so within one bf16 step (2^-7 of the largest |gradient|) of the f32
    dense transpose of the same cotangent."""
    rng = np.random.default_rng(6)
    boxes = _box_sets(rng, oversize=True)
    g16 = torch.from_numpy(rng.normal(size=(2, 12, 7, 7, 64)).astype(np.float32)).to(torch.bfloat16)
    g32 = g16.float().numpy()
    feats = tuple(jnp.zeros(s, jnp.float32) for s in SHAPES)
    want = jax.jit(lambda f, b, g: _bwd_dense(SCALES, 7, 2, (f, b), g))(feats, boxes, g32)
    got = multilevel_roi_align_backward_plain(g16, U.t(boxes), SHAPES, SCALES, 7, 2)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b)
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 2.0**-7 * np.abs(b).max(), (err, np.abs(b).max())


def test_autograd_pooler_matches_jax_vjp():
    """``multilevel_roi_align`` under autograd: the forward equals the
    dense pooler, the feature gradients equal ``jax.vjp`` of it, and the
    boxes get no gradient (the JAX custom VJP returns None for them)."""
    rng = np.random.default_rng(7)
    boxes = _box_sets(rng, oversize=True)
    feats = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    out, vjp = jax.vjp(lambda f: _dense_pool(f, jnp.asarray(boxes), SCALES, 7, 2), tuple(jnp.asarray(f) for f in feats))
    g = rng.normal(size=out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))[0]

    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tb = torch.from_numpy(boxes).requires_grad_()
    got = multilevel_roi_align(tf, tb, SCALES, 7, 2)
    U.assert_close(got, out, atol=1e-4, what="pooled")  # the dense pooler sums in another order
    got.backward(torch.from_numpy(g))
    for f, w in zip(tf, want):
        U.assert_close(f.grad, w, atol=2e-4, what="feature gradient")
    assert tb.grad is None
