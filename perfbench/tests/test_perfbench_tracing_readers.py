"""The readers of the program's host spans on canned traces: ``host_ms`` (the
union of a metric's spans on the host), ``launches`` (the CUDA launch calls
a unit) and ``idle_unlabelled`` (the card's idle time under no program
span)."""

from __future__ import annotations

import types

import pytest

import perfbench_small  # noqa: F401  (puts the repo root on the path)


def _iv(s, e, name="k", labels=()):
    from perfbench.harness.trace import Interval

    return Interval(s, e, name, tuple(labels))


def _ev(name, start_us, device=False):
    return types.SimpleNamespace(name=name, id=0, time_range=types.SimpleNamespace(start=start_us, end=start_us + 1),
                                 device_type="DeviceType.CUDA" if device else "DeviceType.CPU", cpu_parent=None)


def _reading(units=2, dev=(), host=(), events=(), lo=0.0, hi=10.0):
    from perfbench.harness.reading import TraceReading

    r = TraceReading(events=list(events), calls={}, units=units, first="perfbench.step", last="perfbench.step",
                     window_units=1, window_s=1.0, flops_per_unit=1.0, enqueue_ms=[1.0])
    r.dev, r.host, r.lo, r.hi = list(dev), list(host), lo, hi
    return r


def test_host_ms_is_the_union_of_its_spans_clipped_to_the_segment():
    from perfbench.metrics.readers import host_ms

    host = [_iv(-1.0, 1.0, "optimizer_step"), _iv(0.2, 0.6, "grad_clip"),  # a child: no change to the union
            _iv(3.0, 4.0, "optimizer_step"), _iv(3.5, 4.5, "sgd_step"),  # on another thread, past its parent
            _iv(9.0, 12.0, "optimizer_step"), _iv(5.0, 6.0, "backward")]
    r = _reading(host=host)
    spec = {"labels": ["optimizer_step", "grad_fill", "grad_clip", "sgd_step"]}
    # [0, 1] + [3, 4.5] + [9, 10], in ms, over 2 units
    assert host_ms.read(spec, r) == pytest.approx((1.0 + 1.5 + 1.0) * 1e3 / 2)
    assert host_ms.read({"labels": ["backward"]}, r) == pytest.approx(500.0)
    assert host_ms.read({"labels": ["k3_roi_align_bwd"]}, r) is None


def test_launches_counts_every_launch_call_in_the_segment():
    from perfbench.metrics.readers import launches

    events = [_ev("cudaLaunchKernel", 10), _ev("cudaLaunchKernelExC", 20), _ev("cuLaunchKernel", 30),
              _ev("cuLaunchKernelEx", 40), _ev("cudaMemcpyAsync", 50), _ev("cudaMemsetAsync", 60),
              _ev("cudaGraphLaunch", 70),
              _ev("cudaStreamSynchronize", 80), _ev("cudaMalloc", 90), _ev("aten::add", 100),
              _ev("cudaEventRecord", 110),  # not launches
              _ev("cudaLaunchKernel", 5), _ev("cudaLaunchKernel", 300),  # outside [10 us, 200 us)
              _ev("cudaLaunchKernel", 120, device=True)]  # not a host call
    r = _reading(units=7, events=events, lo=10e-6, hi=200e-6)
    assert launches.read({}, r) == 1.0
    assert launches.read({}, _reading(events=[_ev("aten::add", 20)], lo=0.0, hi=1.0)) is None
    assert launches.is_launch("cudaLaunchKernel") and not launches.is_launch("cudaLaunchHostFunc")


def test_idle_unlabelled_counts_gaps_under_the_harness_or_no_span():
    from perfbench.metrics.readers import idle_unlabelled

    dev = [_iv(1.0, 2.0), _iv(3.0, 4.0), _iv(4.5, 5.0), _iv(7.0, 8.0)]
    # gaps: [0, 1] under no span, [2, 3] under loss_sum inside the harness's span, [4, 4.5] under the
    # harness alone, [5, 7] under train_step, [8, 10] under the harness
    host = [_iv(0.6, 10.0, "perfbench.step"), _iv(2.0, 3.5, "loss_sum"), _iv(5.0, 8.0, "train_step")]
    r = _reading(dev=dev, host=host)
    assert idle_unlabelled.read({}, r) == pytest.approx((1.0 + 0.5 + 2.0) * 1e3 / 2)
    assert idle_unlabelled.read({}, _reading(dev=[], host=host)) is None
    # every gap counts, not only the breakdown's ten longest
    many = [_iv(2 * i + 1.0, 2 * i + 2.0) for i in range(30)]
    r = _reading(units=1, dev=many, host=[], lo=0.0, hi=61.0)
    assert idle_unlabelled.read({}, r) == pytest.approx(31.0 * 1e3)
