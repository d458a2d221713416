"""Kernel K4, the mask targets (``models/mask_head.py::crop_masks_to_boxes``).

On the CPU: the router sends CPU tensors to the plain version (the JAX
package's dense contractions, which the other tests/test_torch_port_*.py
hold to JAX) and K4's wrapper refuses what the kernel does not take, checks
it before any launch, and passes the shapes the kernel reads.

Marked ``gpu`` (skips without a card): K4 against the plain version on the
card at the training cells' call and at the lift's 256 px with PRCNN's R 25,
on edge RoIs too: every target equal but at exact ties, where the float64
value of the crop lies within ``chip_smoke.K4_TIE`` of 0.5. On a GPU host:
``python -m pytest tests/test_torch_port_mask_targets.py -m gpu --noconftest``.
"""

import contextlib
import ctypes

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import K4_CASES, exact_crop, k4_against_plain, mask_target_case
from mmt_psm_tpu_torch.models import mask_head as MH
from mmt_psm_tpu_torch.ops import kernels

# small cases on the CPU: (B, S, M, canvas, R)
CPU_CASES = {"r28": (2, 32, 8, 96, 28), "r25": (2, 24, 6, 64, 25), "wide": (1, 16, 3, 80, 7)}


def _case(name, dev=torch.device("cpu")):
    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))
    b, s, m, size, res = (CPU_CASES if dev.type == "cpu" else K4_CASES)[name]
    masks, idx, boxes = mask_target_case(gen, b, s, m, size, dev)
    return masks, idx, boxes, res


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_cpu_route_is_the_plain_version(name):
    masks, idx, boxes, res = _case(name)
    before = MH.crop_masks_to_boxes_cuda.launches
    got = MH.crop_masks_to_boxes(masks, idx, boxes, res)
    assert MH.crop_masks_to_boxes_cuda.launches == before
    assert got.dtype == torch.float32 and got.shape == (*idx.shape, res, res)
    assert torch.equal(got, MH.crop_masks_to_boxes_plain(masks, idx, boxes, res))


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_exact_crop_thresholds_as_the_plain_version(name):
    """The float64 crop that decides the ties: its threshold is the plain
    version's on every pixel but those within float32 rounding of 0.5 (a
    sample coordinate carries ~1e-7 of rounding); both targets occur."""
    masks, idx, boxes, res = _case(name)
    exact = exact_crop(masks, idx, boxes, res)
    plain = MH.crop_masks_to_boxes_plain(masks, idx, boxes, res)
    near = (exact - 0.5).abs() < 1e-6
    assert torch.equal((exact >= 0.5).float()[~near], plain[~near])
    assert 0 < int(plain.sum()) < plain.numel()


class _Lib:
    """A kernel library that records its calls and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def mask_targets(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def card_free(monkeypatch):
    """K4's wrapper on CPU tensors: the device check accepts them and the
    library records its calls instead of launching."""
    lib = _Lib()
    monkeypatch.setattr(kernels, "require_cuda", lambda what, *ts: ts[0].device)
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib


def test_wrapper_refuses_cpu_tensors():
    masks, idx, boxes, res = _case("r28")
    with pytest.raises(ValueError, match="CUDA device"):
        MH.crop_masks_to_boxes_cuda(masks, idx, boxes, res)


def test_wrapper_passes_the_shapes_and_counts_a_launch(card_free):
    masks, idx, boxes, res = _case("r25")
    before = MH.crop_masks_to_boxes_cuda.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = MH.crop_masks_to_boxes_cuda(masks, idx, boxes, res)
    assert MH.crop_masks_to_boxes_cuda.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (*idx.shape, res, res)
    (args,) = card_free.calls
    b, s = idx.shape
    m, hm, wm = masks.shape[1:]
    assert args == (masks.data_ptr(), idx.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, s, m, hm, wm, res, None)
    assert "k4_mask_targets" in {e.name for e in prof.events()}


def test_wrapper_raises_on_a_kernel_error(card_free):
    masks, idx, boxes, res = _case("r28")
    card_free.err = 1
    with pytest.raises(RuntimeError, match="mask_targets"):
        MH.crop_masks_to_boxes_cuda(masks, idx, boxes, res)


REFUSED = {
    "float masks": lambda m, i, b, r: (m.float(), i, b, r),
    "bool masks": lambda m, i, b, r: (m.bool(), i, b, r),
    "int32 rows": lambda m, i, b, r: (m, i.int(), b, r),
    "float64 boxes": lambda m, i, b, r: (m, i, b.double(), r),
    "strided masks": lambda m, i, b, r: (m.transpose(2, 3), i, b, r),
    "strided rows": lambda m, i, b, r: (m, i.t().contiguous().t(), b, r),
    "strided boxes": lambda m, i, b, r: (m, i, b.transpose(0, 1).contiguous().transpose(0, 1), r),
    "3-d masks": lambda m, i, b, r: (m[0], i, b, r),
    "batch mismatch": lambda m, i, b, r: (m[:1], i, b, r),
    "boxes mismatch": lambda m, i, b, r: (m, i, b[:, :-1].contiguous(), r),
    "resolution 0": lambda m, i, b, r: (m, i, b, 0),
    "resolution 129": lambda m, i, b, r: (m, i, b, 129),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(card_free, case):
    masks, idx, boxes, res = _case("r28")
    args = REFUSED[case](masks, idx, boxes, res)
    before = MH.crop_masks_to_boxes_cuda.launches
    with pytest.raises(ValueError, match="crop_masks_to_boxes"):
        MH.crop_masks_to_boxes_cuda(*args)
    assert card_free.calls == [] and MH.crop_masks_to_boxes_cuda.launches == before


def test_kernel_signature():
    """The ctypes argument types the wrapper's call matches."""
    p, i = ctypes.c_void_p, ctypes.c_int
    assert kernels.SIGNATURES["mask_targets"] == {"mask_targets": (p, p, p, p, i, i, i, i, i, i, p)}


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(K4_CASES))
def test_k4_equals_the_plain_version_but_at_exact_ties(dev, name, monkeypatch):
    masks, idx, boxes, res = _case(name, dev)
    before = MH.crop_masks_to_boxes_cuda.launches
    pixels, ties, differ = k4_against_plain(masks, idx, boxes, res, name)
    print(f"K4 {name}: {pixels} target pixels, {ties} exact ties, {differ} differ from the plain version")
    assert MH.crop_masks_to_boxes_cuda.launches == before + 1
    assert differ <= ties

    def dense_on_the_card(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(MH, "crop_masks_to_boxes_plain", dense_on_the_card)
    got = MH.crop_masks_to_boxes(masks, idx, boxes, res)
    assert MH.crop_masks_to_boxes_cuda.launches == before + 2
    again = MH.crop_masks_to_boxes_cuda(masks, idx, boxes, res)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_k4_rows_outside_the_masks_give_nan(dev):
    masks, idx, boxes, res = _case("lift_r25", dev)
    idx = idx.clone()
    idx[0, 0], idx[1, 3] = masks.shape[1], -1
    got = MH.crop_masks_to_boxes_cuda(masks, idx, boxes, res)
    assert got[0, 0].isnan().all() and got[1, 3].isnan().all()
    rest = torch.ones_like(idx, dtype=torch.bool)
    rest[0, 0] = rest[1, 3] = False
    assert not got[rest].isnan().any()
