"""A kernel role's share of its roofline, in %: the least time the chip
could take for the role's traced calls (``perfbench/counts/roles/<count>.py``,
named by ``count``) over the device time of the kernels named in
``kernels``, summed over the same calls."""

from ...counts import kernels as K, roles


def read(spec, reading):
    calls = reading.calls.get(spec["count"], [])
    seconds = reading.kernel_seconds(spec["kernels"])
    if not calls or seconds <= 0:
        return None
    work = roles.role(spec["count"]).work
    least_ms = sum(K.bound(*work(*c))["bound_ms"] for c in calls)
    return 100.0 * least_ms / (seconds * 1e3)
