"""Port NMS (``mmt_psm_tpu_torch.ops.nms``) against the JAX package's NMS.

On the CPU the port runs the plain version of kernel K1, the same
function the card's kernel computes. Keep masks must be identical (exact,
no tolerance) to ``mmt_psm_tpu.ops.nms.nms_mask`` (the XLA tile scan),
``nms_mask_reference`` (the sequential oracle) and, at small N, the Pallas
kernel in interpret mode, including score ties, identical boxes,
all-invalid problems and N that is not a multiple of 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_psm_tpu.ops import nms as jnms
from mmt_psm_tpu.ops.nms_pallas import nms_mask_pallas
from mmt_psm_tpu_torch.ops import nms as N

torch.set_num_threads(1)


def _problems(seed, p, n, canvas=300.0, ties=True):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, canvas, (p, n, 2))
    wh = rng.uniform(2, canvas / 4, (p, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if ties:
        scores = (rng.integers(0, 16, (p, n)) / 16).astype(np.float32)
        boxes[:, 1::7] = boxes[:, 0:-1:7][:, : boxes[:, 1::7].shape[1]]  # identical boxes
    else:
        scores = rng.uniform(size=(p, n)).astype(np.float32)
    valid = rng.uniform(size=(p, n)) > 0.15
    valid[0] = False  # an all-invalid problem
    return boxes, scores, valid


@pytest.mark.parametrize("n,thr", [(90, 0.55), (90, 0.5), (768, 0.7), (1000, 0.7), (130, 0.5), (64, 0.7)])
def test_nms_mask_identical_to_jax(n, thr):
    boxes, scores, valid = _problems(n, 3, n)
    got = N.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr).numpy()
    for i in range(3):
        args = (jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]), thr)
        np.testing.assert_array_equal(got[i], np.asarray(jnms.nms_mask(*args)))
        np.testing.assert_array_equal(got[i], np.asarray(jnms.nms_mask_reference(*args)))
    assert not got[0].any()


@pytest.mark.parametrize("n,thr", [(90, 0.55), (200, 0.5)])
def test_nms_mask_identical_to_pallas_interpret(n, thr):
    boxes, scores, valid = _problems(100 + n, 2, n)
    got = N.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr).numpy()
    for i in range(2):
        want = nms_mask_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]), thr, interpret=True)
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_per_problem_thresholds():
    """One batch, a threshold per problem (the relation-NMS call: 0.55 for
    cytoplasm, 0.5 for nuclei) equals one call per threshold."""
    boxes, scores, valid = _problems(7, 4, 90)
    thr = torch.tensor([0.55, 0.55, 0.5, 0.5])
    got = N.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr)
    for i, t in enumerate([0.55, 0.55, 0.5, 0.5]):
        one = N.nms_mask(torch.from_numpy(boxes[i:i + 1]), torch.from_numpy(scores[i:i + 1]),
                         torch.from_numpy(valid[i:i + 1]), t)
        assert torch.equal(got[i], one[0])


@pytest.mark.parametrize("n,max_out,thr", [(90, 90, 0.5), (300, 64, 0.7), (40, 64, 0.7)])
def test_nms_topk_identical_to_jax(n, max_out, thr):
    """Indices and valid slots identical, padding slots index 0 included."""
    boxes, scores, valid = _problems(n + max_out, 3, n)
    idx, v = N.nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr, max_out)
    for i in range(3):
        jidx, jv = jnms.nms_topk(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]), thr, max_out)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(v[i].numpy(), np.asarray(jv))


def test_nms_mask_plain_is_the_cpu_path():
    boxes, scores, valid = _problems(3, 2, 100, ties=False)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.6)
    assert torch.equal(N.nms_mask(*args), N.nms_mask_plain(*args))
    assert N.suppress_cuda.launches == 0  # CPU tensors never reach the kernel wrapper


def test_kernel_wrapper_rejects_bad_inputs():
    boxes = torch.zeros(2, 10, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        N.suppress_cuda(boxes, torch.ones(2, 10, dtype=torch.bool), torch.zeros(2))


def test_kernel_wrapper_rejects_too_many_boxes():
    """K1's scan stages its suppression words in shared memory: past
    ``MAX_KERNEL_BOXES`` a problem the wrapper raises before any launch."""
    n = N.MAX_KERNEL_BOXES + 1
    with pytest.raises(ValueError):
        N.suppress_cuda(torch.zeros(1, n, 4), torch.ones(1, n, dtype=torch.bool), torch.zeros(1))
    assert N.suppress_cuda.launches == 0


def _chain(n, start):
    """Boxes in score order where, from row ``start`` on, box i overlaps box
    i+1 at IoU 2/3 and box i+2 at 3/7 (+1 areas); earlier rows lie apart."""
    i = np.arange(n, dtype=np.float32)
    x = np.where(i < start, -100.0 * (i + 1), 2.0 * i).astype(np.float32)
    boxes = np.stack([x, np.zeros_like(x), x + 9.0, np.full_like(x, 10.0)], -1)
    return boxes, (n - i).astype(np.float32), np.ones(n, bool)


def _same_as_jax(boxes, scores, valid, thr):
    got = N.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thr).numpy()
    for i in range(boxes.shape[0]):
        args = (jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]), thr)
        np.testing.assert_array_equal(got[i], np.asarray(jnms.nms_mask(*args)))
        np.testing.assert_array_equal(got[i], np.asarray(jnms.nms_mask_reference(*args)))
    return got


@pytest.mark.parametrize("n,start", [(300, 0), (300, 1), (200, 61), (130, 63), (65, 64)])
def test_nms_chain_across_block_borders(n, start):
    """A chain of overlaps whose keeps alternate from ``start`` at 0.5: with
    these starts a kept row suppresses the next one across the 64- and
    128-row borders of K1's and JAX's blocks, in both parities."""
    boxes, scores, valid = (a[None] for a in _chain(n, start))
    got = _same_as_jax(boxes, scores, valid, 0.5)
    i = np.arange(n)
    np.testing.assert_array_equal(got[0], (i < start) | ((i - start) % 2 == 0))


@pytest.mark.parametrize("n,thr", [(300, 0.0), (65, 0.0), (300, 1.0), (129, 1.0)])
def test_nms_threshold_edges(n, thr):
    """Threshold 0: every pair suppresses, so the best valid box alone is
    kept; threshold 1: only exact repeats (IoU exactly 1) suppress."""
    boxes, scores, valid = _problems(n + int(10 * thr), 3, n, ties=False)
    boxes[:, 1::3] = boxes[:, 0::3][:, : boxes[:, 1::3].shape[1]]
    got = _same_as_jax(boxes, scores, valid, thr)
    if thr == 0.0:
        assert got[1:].sum(1).tolist() == [1, 1]
        assert not got[0].any()
