"""Idle ms a batch or step that no program span accounts for: the traced
segment's idle gaps on the card (every one, not the breakdown's ten) whose
innermost open host span is a harness label (``perfbench.*``) or none, over
the segment's units; None where no device work was traced. What is left is
host work outside every span of the program that the metric files name."""

from ...harness import trace as T

HARNESS = "perfbench."


def read(spec, reading):
    if not reading.dev:
        return None
    gaps = T.idle_gaps(reading.dev, reading.lo, reading.hi)
    named = T.gaps_by_host(gaps, reading.host, len(gaps))
    return sum(s for name, s in named if name == "no label" or name.startswith(HARNESS)) * 1e3 / reading.units
