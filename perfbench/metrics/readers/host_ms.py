"""Host ms a batch or step inside the metric's ``labels`` (the program's
``record_function`` names): the union of those spans on the host, on any
thread, clipped to the traced segment, over the segment's units; None where
the trace holds none of them. A file lists a span's children beside it:
they leave the union as it is, and their names reach the breakdown's idle
gaps (the reading resolves every label a metric file names)."""

from ...harness import trace as T


def read(spec, reading):
    want = set(spec["labels"])
    spans = [h for h in reading.host if h.name in want]
    return T.union_seconds(spans, reading.lo, reading.hi) * 1e3 / reading.units if spans else None
