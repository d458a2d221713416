"""Kernels K1, K2 and K3 on the card against their plain versions.

Marked ``gpu``: each test skips, with its reason, where no CUDA device is
present (the other tests/test_torch_port_*.py hold the plain versions to
the JAX package on the CPU).
On a GPU host: ``python -m pytest tests/test_torch_port_cuda.py -m gpu --noconftest``
(tests/conftest.py imports JAX, which a GPU host need not have).
``chip_smoke.py`` makes the same comparisons at the flagship's shapes.
"""

import pytest
import torch

from mmt_psm_tpu_torch.ops import nms as N
from mmt_psm_tpu_torch.ops import pooler as P

pytestmark = pytest.mark.gpu

SCALES = (0.25, 0.125, 0.0625, 0.03125)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _boxes(gen, shape, canvas, dev):
    wh = 4 + (canvas / 2) * torch.rand(*shape, 2, generator=gen, device=dev) ** 2
    xy = torch.rand(*shape, 2, generator=gen, device=dev) * canvas - 20
    return torch.cat([xy, xy + wh], -1)


@pytest.mark.parametrize("p,n,thr", [(20, 1000, 0.7), (20, 2000, 0.7), (8, 90, 0.55), (3, 130, 0.5), (2, 1, 0.5)])
def test_nms_kernel_identical_to_plain(dev, p, n, thr):
    gen = torch.Generator(device=dev).manual_seed(n)
    boxes = _boxes(gen, (p, n), 512, dev)
    scores = (torch.rand(p, n, generator=gen, device=dev) * 10).floor()  # ties
    valid = torch.rand(p, n, generator=gen, device=dev) > 0.1
    before = N.suppress_cuda.launches
    got = N.nms_mask(boxes, scores, valid, thr)
    assert N.suppress_cuda.launches == before + 1
    assert torch.equal(got, N.nms_mask_plain(boxes, scores, valid, thr))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("n,p", [(300, 7), (50, 14)])
def test_roi_align_kernel_matches_plain(dev, dtype, rtol, n, p):
    """f32: 1e-5 abs; bf16: one bf16 rounding of the same f32 sum (2^-7 rel)."""
    gen = torch.Generator(device=dev).manual_seed(p)
    feats = [torch.randn(2, 128 >> i, 128 >> i, 64, generator=gen, device=dev).to(dtype) for i in range(4)]
    boxes = _boxes(gen, (2, n), 512, dev)
    boxes[:, 0] = torch.tensor([-100.0, 200.0, 700.0, 230.0], device=dev)  # far beyond a 48-cell window
    got = P.multilevel_roi_align(feats, boxes, SCALES, p, 2)
    want = P.multilevel_roi_align_plain(feats, boxes, SCALES, p, 2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p", [(300, 7), (50, 14)])
def test_roi_align_backward_kernel_matches_plain(dev, dtype, n, p):
    """K3 against the plain index_add_ transpose. f32: 1e-4 abs, the same
    float32 sums in atomic order; bf16: that sum rounded once, so at most one
    bf16 step (2^-7 of the largest |gradient|). Half the RoIs come in
    clusters of 10 within 1 px, so the atomic adds collide."""
    gen = torch.Generator(device=dev).manual_seed(p + 1)
    shapes = [(2, 128 >> i, 128 >> i, 64) for i in range(4)]
    boxes = _boxes(gen, (2, n), 512, dev)
    m = n - n // 2
    centres = boxes[:, n // 2:n // 2 + m // 10 + 1].repeat_interleave(10, dim=1)[:, :m]
    boxes[:, n // 2:] = centres + torch.rand(2, m, 4, generator=gen, device=dev)
    boxes[:, 0] = torch.tensor([-100.0, 200.0, 700.0, 230.0], device=dev)  # far beyond a 48-cell window
    grad = torch.randn(2, n, p, p, 64, generator=gen, device=dev).to(dtype)
    before = P.multilevel_roi_align_backward_cuda.launches
    got = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, p, 2)
    assert P.multilevel_roi_align_backward_cuda.launches == before + 1
    want = P.multilevel_roi_align_backward_plain(grad, boxes, shapes, SCALES, p, 2)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0.0)


def test_roi_align_autograd_runs_k2_and_k3(dev):
    """Through ``multilevel_roi_align`` the forward launches K2 and the
    backward K3, and the feature gradients equal the plain backward's."""
    gen = torch.Generator(device=dev).manual_seed(9)
    feats = [torch.randn(2, 64 >> i, 64 >> i, 32, generator=gen, device=dev).requires_grad_() for i in range(4)]
    boxes = _boxes(gen, (2, 40), 256, dev)
    k2, k3 = P.multilevel_roi_align_cuda.launches, P.multilevel_roi_align_backward_cuda.launches
    out = P.multilevel_roi_align(feats, boxes, SCALES, 7, 2)
    g = torch.randn(out.shape, generator=gen, device=dev)
    out.backward(g)
    assert (P.multilevel_roi_align_cuda.launches, P.multilevel_roi_align_backward_cuda.launches) == (k2 + 1, k3 + 1)
    want = P.multilevel_roi_align_backward_plain(g, boxes, [f.shape for f in feats], SCALES, 7, 2)
    for f, w in zip(feats, want):
        torch.testing.assert_close(f.grad, w, atol=1e-4, rtol=0.0)
