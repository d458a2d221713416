"""Device ms a batch or step of the work launched inside the metric's
``labels`` (the program's ``record_function`` names): the union of its
device intervals in the traced segment, over the segment's units."""


def read(spec, reading):
    return reading.union_ms_per_unit(spec["labels"])
