"""A kernel role's share of its roofline, in %: the least time the chip
could take for the role's traced calls (``perfbench/counts/kernels.py``,
named by ``count``) over the device time of the kernels named in
``kernels``, summed over the same calls."""

from ...counts import kernels as K


def _least_ms(count: str, calls) -> float:
    total = 0.0
    for c in calls:
        if count == "k1_nms":
            nbytes, ops = K.k1_nms(*c)
        elif count == "k2_roi_align":
            shapes, boxes, scales, p, g, elem = c
            nbytes, ops = K.k2_roi_align(shapes, boxes, scales, p, g, elem)
        else:
            shapes, boxes, p, elem = c
            nbytes, ops = K.k3_roi_align_bwd(shapes, boxes, p, elem)
        total += K.bound(nbytes, ops)["bound_ms"]
    return total


def read(spec, reading):
    calls = reading.calls.get(spec["count"], [])
    seconds = reading.kernel_seconds(spec["kernels"])
    if not calls or seconds <= 0:
        return None
    return 100.0 * _least_ms(spec["count"], calls) / (seconds * 1e3)
