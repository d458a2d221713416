"""What a traced segment gives the per-layer readers.

The segment runs ``units`` batches or steps under ``torch.profiler``; it
spans from the start of the first ``first`` host label to the end of the
last ``last`` one. The main window's host-side numbers (units completed,
seconds, the enqueue times) ride along for the metrics that read them.
"""

from __future__ import annotations

import dataclasses
import re

from . import trace as T


@dataclasses.dataclass
class TraceReading:
    events: list
    calls: dict
    units: int
    first: str
    last: str
    window_units: int
    window_s: float
    flops_per_unit: float
    enqueue_ms: list

    def resolve(self, labels):
        """Attribute the device work to ``labels`` (with the segment's own)."""
        labels = set(labels) | {self.first, self.last}
        self.dev, self.host = T.device_intervals(self.events, labels)
        firsts = [h.start for h in self.host if h.name == self.first]
        lasts = [h.end for h in self.host if h.name == self.last]
        if not firsts or not lasts:
            raise RuntimeError(f"the trace holds no {self.first!r} or {self.last!r} span")
        self.lo, self.hi = min(firsts), max(lasts)
        return self

    def busy_and_window(self):
        return T.union_seconds(self.dev, self.lo, self.hi), self.hi - self.lo

    def union_ms_per_unit(self, labels):
        """Device ms a unit of the union of the work launched inside ``labels``,
        or None where there is none."""
        sel = T.under(self.dev, labels)
        return T.union_seconds(sel, self.lo, self.hi) * 1e3 / self.units if sel else None

    def kernel_seconds(self, names) -> float:
        pats = [re.compile(rf"\b{re.escape(n)}\b") for n in names]
        return sum(min(i.end, self.hi) - max(i.start, self.lo) for i in self.dev
                   if any(p.search(i.name) for p in pats) and i.end > self.lo and i.start < self.hi)

    def describe(self) -> str:
        inside = [i for i in self.dev if i.end > self.lo and i.start < self.hi]
        total = sum(i.end - i.start for i in inside)
        labelled = sum(i.end - i.start for i in inside if set(i.labels) - {self.first, self.last})
        return (f"{len(inside)} device ops over {self.units} units in {self.hi - self.lo:.6f} s, "
                f"{total:.6f} s of device time, {100 * labelled / max(total, 1e-12):.2f}% of it under a "
                f"program label; calls recorded: " + ", ".join(f"{k} {len(v)}" for k, v in self.calls.items()))

    def breakdown(self, n: int = 10) -> dict:
        inside = [i for i in self.dev if i.end > self.lo and i.start < self.hi]
        return {"device_ops": T.top_ops(inside, n),
                "idle_gaps": T.gaps_by_host(T.idle_gaps(self.dev, self.lo, self.hi), self.host, n)}
