"""A stage's share of the card's compute roofline, in %: the model FLOPs of
the stages named in ``stages`` (of the count of the configuration named in
``config``, ``perfbench/counts/models/``) over the device time of the work
launched inside the metric's ``labels`` (the union of its intervals), a
traced batch or step, against the published bf16 dense peak
(``perfbench/counts/peaks.json``). For a stage that no hand-written kernel
implements, whose work is the library's convolutions and element-wise ops.

The traced cell's FLOPs a unit are the count's at its batch, and every
count is linear in the batch, so the stages' FLOPs a unit are the unit's
FLOPs times the stages' share of the configuration's count; None where
the segment holds no such span, or where the unit's FLOPs are not a whole
number of the configuration's images (a cell of another configuration)."""

from ...counts.kernels import PEAKS
from ...counts.models import count
from ...harness import spec as S


def read(spec, reading):
    ms = reading.union_ms_per_unit(spec["labels"])
    if not ms:
        return None
    conf = S.config(spec["config"])
    per_image = count(conf["flops"], conf["model"], 1)
    images = reading.flops_per_unit / sum(per_image.values())
    if images < 1 or images != round(images):
        return None
    flops = images * sum(per_image[s] for s in spec["stages"])
    return 100.0 * flops / (ms * 1e-3) / PEAKS["bf16_flops_per_s"]
