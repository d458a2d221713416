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

from chip_smoke import NMS_EDGE_CASES, nms_edge_case
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


@pytest.mark.parametrize("case", list(NMS_EDGE_CASES))
def test_nms_kernel_edge_cases(dev, case):
    """K1 on the cases that stress its block-wise scan (chains that cross
    64-row borders, one box repeated, no overlaps, thresholds 0 and 1, N
    around one word, N = 6000 and 12000): keeps identical to the plain
    version, and to the greedy result where the case's construction gives it."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    boxes, scores, valid, thr, keep = nms_edge_case(case, gen, dev)
    got = N.nms_mask(boxes, scores, valid, thr)
    assert torch.equal(got, N.nms_mask_plain(boxes, scores, valid, thr))
    if keep is not None:
        assert torch.equal(got, keep)


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
    float32 sums in another order; bf16: that sum rounded once, so at most one
    bf16 step (2^-7 of the largest |gradient|). Half the RoIs come in
    clusters of 10 within 1 px, so they add into the same cells."""
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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("c", [256, 512])
def test_roi_align_kernel_wide_channels(dev, dtype, rtol, c):
    """K2 at the FPN's width and at twice it (a lane owns 8 channels, a
    block loops over 256-channel chunks): f32 1e-5 abs, bf16 one rounding."""
    gen = torch.Generator(device=dev).manual_seed(c)
    feats = [torch.randn(2, 128 >> i, 128 >> i, c, generator=gen, device=dev).to(dtype) for i in range(4)]
    boxes = _boxes(gen, (2, 120), 512, dev)
    for p in (7, 14):
        got = P.multilevel_roi_align(feats, boxes, SCALES, p, 2)
        want = P.multilevel_roi_align_plain(feats, boxes, SCALES, p, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=rtol)


def _k3_case(gen, case, dev):
    """Boxes [1, n, 4] on a 1024 canvas for one K3 case (levels 256^2 ... 32^2,
    a tile of 4 cells a side spans 16, 32, 64 and 128 px of the canvas at levels 0-3)."""
    if case == "tile_borders":  # level-0 RoIs whose samples straddle tile rows and columns
        k = torch.arange(24, device=dev, dtype=torch.float32)
        x0 = 32.0 * (k % 6 + 1) - 2.0 + 0.25 * (k % 4)
        y0 = 32.0 * (k // 6 + 1) - 1.0
        boxes = torch.stack([x0, y0, x0 + 29.0 + k, y0 + 31.0], -1)
    elif case == "outside":  # partly outside the map, every level
        boxes = torch.tensor([[-40.0, -30.0, 60.0, 50.0], [980.0, 990.0, 1100.0, 1080.0],
                              [-300.0, 400.0, 200.0, 700.0], [700.0, -500.0, 1300.0, 300.0],
                              [-900.0, -900.0, 1900.0, 1900.0]], device=dev)
    elif case == "p5_many_tiles":  # ~32 cells on P5 (8 tiles a side), ~20 on P4
        boxes = torch.tensor([[0.0, 0.0, 1023.0, 1023.0], [10.0, 20.0, 1000.0, 990.0],
                              [100.0, 60.0, 420.0, 380.0]], device=dev)
    else:  # "clustered": 4 clusters of 10 boxes within 1 px, so they share cells
        centres = _boxes(gen, (1, 4), 1024, dev)
        boxes = centres.repeat_interleave(10, dim=1)[0] + torch.rand(40, 4, generator=gen, device=dev)
    return boxes[None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["tile_borders", "outside", "p5_many_tiles", "clustered", "zero_cotangent"])
def test_roi_align_backward_kernel_cases(dev, dtype, case):
    """K3 against the plain transpose on RoIs that K3's tiles must
    split or drop right (f32 1e-4 abs, bf16 one step); levels that no RoI
    maps to, and an all-zero cotangent, come out all zero."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    shapes = [(1, 256 >> i, 256 >> i, 64) for i in range(4)]
    boxes = _k3_case(gen, "clustered" if case == "zero_cotangent" else case, dev)
    n, p = boxes.shape[1], 7 if case != "clustered" else 14
    grad = torch.randn(1, n, p, p, 64, generator=gen, device=dev).to(dtype)
    if case == "zero_cotangent":
        grad.zero_()
    got = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, p, 2)
    want = P.multilevel_roi_align_backward_plain(grad, boxes, shapes, SCALES, p, 2)
    used = set(P._levels(boxes, SCALES).flatten().tolist())
    for lv, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape
        if lv not in used or case == "zero_cotangent":
            assert not g.any(), f"level {lv} must be all zero"
        atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0.0)
    if case == "tile_borders":
        assert used == {0} and 3 not in used
    if case == "p5_many_tiles":
        assert 3 in used


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_deterministic(dev, dtype):
    """No atomics: two launches on the same inputs give bit-identical gradients."""
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = [(2, 128 >> i, 128 >> i, 256) for i in range(4)]
    boxes = torch.cat([_boxes(gen, (2, 100), 512, dev), _k3_case(gen, "clustered", dev).expand(2, -1, -1) / 2], 1)
    grad = torch.randn(2, boxes.shape[1], 7, 7, 256, generator=gen, device=dev).to(dtype)
    first = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, 7, 2)
    second = P.multilevel_roi_align_backward_cuda(grad, boxes, shapes, SCALES, 7, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
