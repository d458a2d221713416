"""CUDA launch calls a batch or step: the host calls that queue work on the
card (kernel launches through the runtime or the driver, asynchronous copies
and sets, graph launches), on every thread, that start inside the traced
segment, over the segment's units; None where the trace holds none (no
card). A count: two runs of one cell read the same where the program's
launches do not depend on its data."""

from ...harness import trace as T

PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
NAMES = frozenset({"cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch"})


def is_launch(name: str) -> bool:
    return name in NAMES or name.startswith(PREFIXES)


def read(spec, reading):
    lo, hi = reading.lo * 1e6, reading.hi * 1e6  # the events' clock is in us
    n = sum(1 for e in reading.events
            if not T._is_device(e) and is_launch(e.name) and lo <= e.time_range.start < hi)
    return n / reading.units if n else None
