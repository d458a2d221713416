"""FrozenBN applied in the ResNet body's conv epilogues where no gradient is recorded.

With ``torch.is_grad_enabled()`` False the stem, each bottleneck and the
C4 stage-5 head run each conv-FrozenBN pair as kernel K5
(``layers.prepare_conv_bn``: the conv's weight in the compute dtype and
FrozenBN's scale and shift), the conv, and kernel K6
(``layers.bn_residual_relu``: scale, shift, residual and ReLU in one pass
over the conv's output); with gradients on they run today's formula,
module after module. On the CPU both kernels are their plain versions.

* The no-grad forward against today's formula, with FrozenBN statistics
  drawn as ``torch_port_util.build_pair`` draws them: equal bit for bit in
  float32 and in bf16 (K6 rounds after every operation as the unfused
  operators do), and so within any bound on bf16 steps.
* The grad-enabled path bit-identical to today's formula; ``state_dict``
  keys unchanged; nothing cached: a forward after an in-place EMA update
  equals one of a fresh copy.
* On the card (marked ``gpu``, skipped without one): K5 and K6 equal to
  their plain versions at the flagship's ``layer1`` shapes and C4's stage-5
  shapes, bf16 and float32; a served FPN forward launches K5 53 times and
  K6 49 times, a supervised ``Trainer.step`` neither. Run there with
  ``python -m pytest tests/test_torch_port_frozen_bn_fold.py -m gpu --noconftest``.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmt_psm_tpu_torch.models import layers as L
from mmt_psm_tpu_torch.models.c4 import ResNetStage5Head
from mmt_psm_tpu_torch.models.resnet import Bottleneck, ResNet, Stem
from mmt_psm_tpu_torch.train.ema import ema_update_

def randomize(module, seed):
    """Seeded conv weights, and FrozenBN statistics as ``torch_port_util``
    draws them (weight 0.5-1.5, var 0.5-2.0, mean and bias non-zero)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, L.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.from_numpy(rng.normal(0.0, fan_in**-0.5, m.weight.shape)))
            elif isinstance(m, L.FrozenBatchNorm2d):
                n = m.weight.shape
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, n)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n)))
    return module


def todays_conv(conv, x):
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, conv.dilation, conv.groups)


def todays_bn(bn, x):
    scale = bn.weight * torch.reciprocal(torch.sqrt(bn.running_var))
    shift = bn.bias - bn.running_mean * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def todays(m, x):
    """The formula the body computed before the fold: conv, FrozenBN's
    multiply and add, ReLU and the residual add, each its own operation."""
    if isinstance(m, Stem):
        return F.max_pool2d(F.relu(todays_bn(m.bn1, todays_conv(m.conv1, x))), kernel_size=3, stride=2, padding=1)
    if isinstance(m, Bottleneck):
        residual = x if m.downsample is None else todays_bn(m.downsample[1], todays_conv(m.downsample[0], x))
        out = F.relu(todays_bn(m.bn1, todays_conv(m.conv1, x)))
        out = F.relu(todays_bn(m.bn2, todays_conv(m.conv2, out)))
        return F.relu(todays_bn(m.bn3, todays_conv(m.conv3, out)) + residual)
    for block in m.layer4:
        x = todays(block, x)
    return x


# name -> (module, input shape [N, C, H, W], K5 calls, K6 calls of a folded forward)
CASES = {
    "stem": (lambda: Stem(64), (2, 3, 32, 32), 1, 1),
    "bottleneck_downsample": (lambda: Bottleneck(64, 64, 256), (2, 64, 16, 16), 4, 3),
    "bottleneck": (lambda: Bottleneck(256, 64, 256), (2, 256, 16, 16), 3, 3),
    "bottleneck_stride2": (lambda: Bottleneck(256, 128, 512, stride=2), (2, 256, 16, 16), 4, 3),
    "stage5_head": (lambda: ResNetStage5Head(1024), (2, 1024, 14, 14), 10, 9),
}


def case(name, dtype, seed=0):
    make, shape, _, _ = CASES[name]
    m = randomize(make(), seed).eval()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g)
    if name != "stem":
        x = torch.relu(x)  # a block's input is a ReLU's output
    return m, x.to(dtype).contiguous(memory_format=torch.channels_last)


class Calls:
    """Counts the plain K5 and K6 calls (the CPU's side of the kernels)."""

    def __enter__(self):
        self.k5 = self.k6 = 0
        fold, epi = L.prepare_conv_bn_plain, L.bn_residual_relu_plain

        def k5(*a):
            self.k5 += 1
            return fold(*a)

        def k6(*a):
            self.k6 += 1
            return epi(*a)

        self._patches = [mock.patch.object(L, "prepare_conv_bn_plain", k5),
                         mock.patch.object(L, "bn_residual_relu_plain", k6)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_no_grad_forward_is_todays_formula_bit_for_bit(name, dtype):
    m, x = case(name, dtype)
    with torch.no_grad(), Calls() as calls:
        got = m(x)
    assert (calls.k5, calls.k6) == CASES[name][2:]
    with torch.no_grad():
        want = todays(m, x)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_grad_enabled_forward_is_todays_formula_bit_for_bit(name, dtype):
    m, x = case(name, dtype, seed=1)
    with torch.enable_grad(), Calls() as calls:
        got = m(x)
    assert (calls.k5, calls.k6) == (0, 0)
    with torch.no_grad():
        want = todays(m, x)
    assert torch.equal(got, want)


def test_r50_body_runs_k5_and_k6_once_a_conv():
    """The R-50-FPN body's 53 FrozenBNs: 53 K5 calls and 49 K6 calls (the 4
    downsample branches ride in their blocks' last epilogue) a no-grad
    forward, none with gradients on; the same float32 outputs."""
    body = randomize(ResNet("R-50-FPN", freeze_at=0), 2).eval()
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(2)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad(), Calls() as calls:
        got = body(x)
    assert (calls.k5, calls.k6) == (53, 49)
    with torch.enable_grad(), Calls() as calls:
        want = body(x)
    assert (calls.k5, calls.k6) == (0, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w.detach())


def test_state_dict_keys_unchanged():
    m = Bottleneck(64, 64, 256)
    bn = ["weight", "bias", "running_mean", "running_var"]
    keys = ["downsample.0.weight", *[f"downsample.1.{k}" for k in bn]]
    for i in (1, 2, 3):
        keys += [f"conv{i}.weight", *[f"bn{i}.{k}" for k in bn]]
    assert sorted(m.state_dict()) == sorted(keys)
    with torch.no_grad():
        m(torch.randn(1, 64, 8, 8).contiguous(memory_format=torch.channels_last))
    assert sorted(m.state_dict()) == sorted(keys)
    assert sorted(Stem().state_dict()) == sorted(["conv1.weight", *[f"bn1.{k}" for k in bn]])


def test_forward_after_an_ema_update_equals_a_fresh_copy():
    """The fold reads the weights and buffers on every call: after an
    in-place EMA update of a model that has already served, its forward
    equals that of a fresh copy of the updated model."""
    teacher, x = case("bottleneck_downsample", torch.float32, seed=3)
    student = randomize(copy.deepcopy(teacher), 4)
    with torch.no_grad():
        teacher(x)  # a forward before the update
    ema_update_(list(teacher.state_dict().values()), list(student.state_dict().values()), 10, 0.99)
    fresh = copy.deepcopy(teacher)
    with torch.no_grad():
        assert torch.equal(teacher(x), fresh(x))
        assert not torch.equal(teacher(x), student(x))


# ---------------------------------------------------------------- on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 and K6 have no CPU mode")
    return torch.device("cuda")


# (conv weight [O, I, kh, kw], activation [N, O, H, W], its residual: none,
# added as it is, or a downsample's to scale and shift): the flagship's
# layer1 at batch 4 on the 1024 canvas (256 x 256 maps), C4's stage 5 on
# 2,000 RoIs (7 x 7 maps)
KERNEL_SHAPES = {
    "layer1_conv1": ((64, 64, 1, 1), (4, 64, 256, 256), None),
    "layer1_conv2": ((64, 64, 3, 3), (4, 64, 256, 256), None),
    "layer1_conv3": ((256, 64, 1, 1), (4, 256, 256, 256), "downsample"),
    "layer1_conv3_identity": ((256, 64, 1, 1), (4, 256, 256, 256), "identity"),
    "stage5_conv2": ((512, 512, 3, 3), (2000, 512, 7, 7), None),
    "stage5_conv3": ((2048, 512, 1, 1), (2000, 2048, 7, 7), "downsample"),
    "stage5_conv3_identity": ((2048, 512, 1, 1), (2000, 2048, 7, 7), "identity"),
}


def _bn(o, gen, dev):
    bn = L.FrozenBatchNorm2d(o).to(dev)
    bn.weight.uniform_(0.5, 1.5, generator=gen)
    bn.bias.normal_(0.0, 0.1, generator=gen)
    bn.running_mean.normal_(0.0, 0.1, generator=gen)
    bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return bn


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(KERNEL_SHAPES))
def test_kernels_equal_their_plain_versions_on_the_card(dev, name, dtype):
    wshape, yshape, residual = KERNEL_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(len(name))
    w = torch.randn(wshape, generator=gen, device=dev)
    bn = _bn(wshape[0], gen, dev)
    before = (L.prepare_conv_bn_cuda.launches, L.bn_residual_relu_cuda.launches)
    got_w, ss = L.prepare_conv_bn(w, bn, dtype)
    want_w, want_ss = L.prepare_conv_bn_plain(w, bn, dtype)
    assert got_w.dtype == dtype and got_w.shape == w.shape and got_w.is_contiguous()
    assert torch.equal(got_w, want_w) and torch.equal(ss, want_ss)
    cl = torch.channels_last
    y = torch.randn(yshape, generator=gen, device=dev).to(dtype).contiguous(memory_format=cl)
    res = rss = None
    if residual:
        res = torch.randn(yshape, generator=gen, device=dev).to(dtype).contiguous(memory_format=cl)
    if residual == "downsample":
        rss = L.prepare_conv_bn(w, _bn(wshape[0], gen, dev), dtype)[1]
    want = L.bn_residual_relu_plain(y, ss, res, rss)
    got = L.bn_residual_relu(y.clone(memory_format=cl), ss, res, rss)
    assert got.dtype == dtype and got.is_contiguous(memory_format=cl)
    assert torch.equal(got, want)
    k5 = 2 if residual == "downsample" else 1
    assert (L.prepare_conv_bn_cuda.launches, L.bn_residual_relu_cuda.launches) == (before[0] + k5, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_no_grad_forward_without_cudnn_on_the_card(dev, dtype):
    """PyTorch's own CUDA conv (cuDNN disabled, as chip_smoke's data-parallel
    float32 check runs) writes NCHW outputs: the no-grad forward still runs
    K5 and K6 and equals today's formula bit for bit."""
    m, x = case("bottleneck_downsample", dtype)
    m, x = m.to(dev), x.to(dev)
    before = (L.prepare_conv_bn_cuda.launches, L.bn_residual_relu_cuda.launches)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
        got = m(x)
        want = todays(m, x)
    assert (L.prepare_conv_bn_cuda.launches, L.bn_residual_relu_cuda.launches) == (before[0] + 4, before[1] + 3)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_epilogue_refuses_what_it_does_not_take(dev):
    ss = torch.zeros(2, 16, device=dev)
    y = torch.zeros(2, 16, 4, 4, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        L.bn_residual_relu_cuda(y, ss)
    odd = torch.zeros(2, 12, 4, 4, device=dev).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="multiple of 8"):
        L.bn_residual_relu_cuda(odd, torch.zeros(2, 12, device=dev))
    base = torch.zeros(2 * 16 * 16 + 1, device=dev)[1:].view(2, 4, 4, 16).permute(0, 3, 1, 2)
    assert base.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="aligned"):
        L.bn_residual_relu_cuda(base, ss)


@pytest.mark.gpu
def test_served_forward_folds_and_a_train_step_does_not(dev):
    """One served flagship forward (R-50-FPN) at a 256 canvas: 53 K5 and 49
    K6 launches; a supervised ``Trainer.step``: none."""
    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.train import build_trainer

    small = ["TPU.IMAGE_SIZE", "256", "TPU.MAX_GT", "16"]
    model = build_model(device=dev, seed=0, opts=small)
    x = torch.randn(2, 256, 256, 3, device=dev) * 40.0
    sizes = torch.tensor([[256, 256], [200, 240]], dtype=torch.int32, device=dev)
    counters = (L.prepare_conv_bn_cuda, L.bn_residual_relu_cuda)
    before = [fn.launches for fn in counters]
    model(x, sizes)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [53, 49]
    trainer = build_trainer(device=dev, opts=small)
    batch = batch_to_torch(generate_batch(0, 2, image_size=256, max_instances=16), dev)
    before = [fn.launches for fn in counters]
    trainer.step(batch)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0]
