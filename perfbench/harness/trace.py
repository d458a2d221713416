"""Reduction of a ``torch.profiler`` trace to device intervals and the
host labels that launched them.

``Interval`` lists come from ``device_intervals``: every kernel, copy and
set on the card (the device-side spans of ``record_function`` labels are
annotations, not work, and are left out), each with the host labels (the
``record_function`` names of the program or the harness asked for) open
around the call that launched it. The arithmetic below works on such lists,
so it is tested on canned ones.

The work of the backward runs on autograd's own thread, outside the
step's labels: it is found as ``scripts/profile_torch_port.py``'s
``backward_by_stage`` finds it, by the autograd nodes' event names
(``BACKWARD_NODE``), and carries the pseudo-label ``BACKWARD_LABEL``.
"""

from __future__ import annotations

import dataclasses

BACKWARD_NODE = "autograd::engine::evaluate_function: "


@dataclasses.dataclass(frozen=True)
class Interval:
    start: float  # seconds on the trace's clock
    end: float
    name: str
    labels: tuple = ()  # the host labels open around its launch, outermost first


def union_seconds(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """Seconds covered by the union of ``intervals`` inside [lo, hi]."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps [start, end) in [lo, hi] where no interval runs, longest first."""
    gaps, at = [], lo
    for s, e in sorted((max(i.start, lo), min(i.end, hi)) for i in intervals):
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def under(intervals, labels) -> list:
    """The intervals launched inside any of ``labels``."""
    want = set(labels)
    return [i for i in intervals if want.intersection(i.labels)]


def top_ops(intervals, n: int = 10):
    """[[name, seconds], ...] of the ``n`` device op names that took most time."""
    by = {}
    for i in intervals:
        by[i.name] = by.get(i.name, 0.0) + (i.end - i.start)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def gaps_by_host(gaps, host_spans, n: int = 10):
    """[[what the host was doing, seconds], ...] for the ``n`` longest gaps:
    the innermost of ``host_spans`` (Interval of host labels) open at each
    gap's middle, or "no label"."""
    out = []
    for s, e in gaps[:n]:
        mid = 0.5 * (s + e)
        inside = [h for h in host_spans if h.start <= mid < h.end]
        name = min(inside, key=lambda h: h.end - h.start).name if inside else "no label"
        out.append([name, e - s])
    return out


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


# the pseudo-label of the work an autograd node launches (the backward runs
# on the engine's own thread, outside the step's host labels)
BACKWARD_LABEL = "autograd.backward"


def _labels_of(e, labels):
    out = []
    while e is not None:
        if e.name in labels:
            out.append(e.name)
        elif e.name.startswith(BACKWARD_NODE) and BACKWARD_LABEL in labels:
            out.append(BACKWARD_LABEL)
        e = e.cpu_parent
    return tuple(reversed(out))


def device_intervals(events, labels):
    """(device Intervals, host label Intervals) of a profiler's
    ``events()``; ``labels`` are the host label names to resolve.

    A device op is tied to the host op that launched it by its correlation
    id: the CUDA launch or copy call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``...) carries the same id, and the host labels open
    around that call are the op's."""
    labels = frozenset(labels)
    launches = {}
    host = []
    for e in events:
        if _is_device(e):
            continue
        if e.name.startswith("cu"):
            launches.setdefault(e.id, e)
        if e.name in labels:
            host.append(Interval(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name))
    dev = []
    for e in events:
        if not _is_device(e) or e.name in labels or getattr(e, "is_user_annotation", False):
            continue
        parent = launches.get(e.id)
        dev.append(Interval(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name,
                            _labels_of(parent, labels) if parent is not None else ()))
    return dev, host
