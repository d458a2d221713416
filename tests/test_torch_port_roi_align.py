"""Port multi-level ROIAlign (``mmt_psm_tpu_torch.ops.pooler``) against
``mmt_psm_tpu.ops.pooler.multilevel_roi_align``, the exact path the JAX
box head takes off-TPU.

On the CPU the port runs the plain version of kernel K2. Tolerance: 1e-5
absolute in float32 on N(0, 1) features. The JAX side runs with jit
disabled, because under jit XLA rewrites the per-axis sample coordinate
``start + p*bin + (i+0.5)*bin/G`` (a reciprocal for the division), which
moves coordinates of up to 64 cells by an ulp (4e-6) and pooled values by
up to ~2e-5; eager JAX evaluates the formula as written, like the port and
the CUDA kernel. The jitted path is held to 1e-4, and the Pallas kernel
(interpret mode) is compared only on RoIs that fit its 48-cell window,
which it clamps beyond.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_psm_tpu.ops.pooler import assign_levels as jassign
from mmt_psm_tpu.ops.pooler import multilevel_roi_align as jpool
from mmt_psm_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas
from mmt_psm_tpu_torch.ops import kernels
from mmt_psm_tpu_torch.ops import pooler as P

torch.set_num_threads(1)

SCALES = (0.25, 0.125, 0.0625, 0.03125)
CANVAS = 512


def _features(seed, b=2, c=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, CANVAS // 4 >> i, CANVAS // 4 >> i, c)).astype(np.float32) for i in range(4)]


def _boxes(seed, b=2, n=48):
    """Mixed RoIs: ordinary ones, ones spanning far more than 48 cells of
    their level (elongated, or larger than the image), ones partly outside
    the image, and squares exactly on the level boundaries (sqrt(area) =
    112, 224, 448 with the +1 convention)."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(4, 200, (b, n, 2))
    xy = rng.uniform(-30, CANVAS - 20, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    special = np.array([
        [0, 200, 511, 230],      # 512 x 31: level 3, 128 cells wide
        [300, 0, 320, 511],      # tall and thin
        [-100, -60, 700, 650],   # larger than the image
        [-20, -20, 30, 25],      # over the top-left corner
        [480, 490, 560, 600],    # over the bottom-right corner
        [10, 10, 121, 121],      # sqrt(area) = 112
        [10, 10, 233, 233],      # 224
        [10, 10, 457, 457],      # 448
        [40, 40, 40.5, 41],      # sub-pixel: size floors at 1
    ])
    boxes[:, : len(special)] = special
    return boxes.astype(np.float32)


def _jax_pool(feats, boxes, p):
    return np.stack([
        np.asarray(jpool([jnp.asarray(f[i]) for f in feats], jnp.asarray(boxes[i]), SCALES, p, 2))
        for i in range(boxes.shape[0])
    ])


@pytest.mark.parametrize("p", [7, 14])
def test_matches_jax_exact_path(p):
    feats, boxes = _features(p), _boxes(p)
    got = P.multilevel_roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), SCALES, p, 2)
    with jax.disable_jit():
        want = _jax_pool(feats, boxes, p)
    assert got.shape == want.shape == (2, boxes.shape[1], p, p, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _jax_pool(feats, boxes, p), rtol=0, atol=1e-4)


def test_matches_pallas_interpret_on_windowed_rois():
    feats = _features(3, c=16)
    rng = np.random.default_rng(4)
    side = rng.uniform(12, 180, (2, 24, 1))
    xy = rng.uniform(10, CANVAS - 200, (2, 24, 2))
    boxes = np.concatenate([xy, xy + side * rng.uniform(0.6, 1.6, (2, 24, 2))], -1).astype(np.float32)
    got = P.multilevel_roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), SCALES, 7, 2)
    want = multilevel_roi_align_pallas(tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes), SCALES, 7, 2, 48, 8, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_assign_levels_identical_at_boundaries():
    s = np.array([111.0, 111.5, 112.0, 112.5, 223.0, 224.0, 225.0, 447.0, 448.0, 449.0, 1.0, 2000.0], np.float32)
    boxes = np.stack([np.zeros_like(s), np.zeros_like(s), s - 1, s - 1], -1)
    got = P.assign_levels(torch.from_numpy(boxes), 2, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jassign(jnp.asarray(boxes), 2, 5)))
    assert list(got[[1, 2, 5, 8]]) == [0, 1, 2, 3]


def test_bfloat16_features_keep_their_dtype():
    feats, boxes = _features(5), _boxes(5)
    f32 = P.multilevel_roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), SCALES, 7, 2)
    bf = P.multilevel_roi_align([torch.from_numpy(f).bfloat16() for f in feats], torch.from_numpy(boxes), SCALES, 7, 2)
    assert bf.dtype == torch.bfloat16
    # inputs rounded to bf16 (rel 2^-9), f32 accumulation, one rounding of the result (rel 2^-9)
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), rtol=2**-7, atol=2e-2)
    assert P.multilevel_roi_align_cuda.launches == 0


def test_kernel_wrapper_rejects_bad_inputs():
    feats = [torch.zeros(1, 8, 8, 4, dtype=torch.float16)] * 4
    with pytest.raises(ValueError):
        P.multilevel_roi_align_cuda(feats, torch.zeros(1, 3, 4), SCALES, 7, 2)


def _misaligned(shape):
    """A contiguous float32 tensor whose base is 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(shape)


def _no_library(name):
    raise AssertionError(f"the wrapper loaded kernel library {name!r} before checking its inputs")


@pytest.mark.parametrize("case", ["channels_not_multiple_of_8", "misaligned_base"])
def test_kernel_wrapper_rejects_what_vector_loads_cannot_take(case, monkeypatch):
    """K2 moves 8 channels a lane with 16-byte loads: its wrapper raises
    ValueError on C % 8 != 0 or a base that is not 16-byte aligned, before
    any kernel library is built or loaded."""
    monkeypatch.setattr(kernels, "library", _no_library)
    if case == "channels_not_multiple_of_8":
        feats = [torch.zeros(1, 32 >> i, 32 >> i, 12) for i in range(4)]
    else:
        feats = [torch.zeros(1, 32 >> i, 32 >> i, 8) for i in range(4)]
        feats[2] = _misaligned((1, 8, 8, 8))
        assert feats[2].is_contiguous() and feats[2].data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="multiple of 8" if case.startswith("channels") else "16-byte"):
        P.multilevel_roi_align_cuda(feats, torch.zeros(1, 3, 4), SCALES, 7, 2)
