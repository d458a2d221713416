"""The lift experiment's arms with the whole model in float32: a diagnostic
of bf16's share in the lift, not a variant of the experiment.

    python3 scripts/lift_f32_torch.py [the flags of mmt_psm_tpu_torch.tools.mt_lift_experiment]

Runs ``mmt_psm_tpu_torch.tools.mt_lift_experiment.main`` with the lift's
``ModelConfig`` computing in float32 (``compute_dtype``, the training and the
held-out model alike) and TF32 off, so every convolution and product is a
float32 one; everything else is the tool's, its flags included (give
``--tag`` so that no bf16 run's checkpoint directory is resumed). The JSON
written to ``--out`` holds the tool's keys, with ``meta.compute_dtype``
"float32" and ``meta.tf32`` false. The JAX script has no such flag either:
its configuration is the lift's ``ModelConfig`` and nothing else. Needs one
card unless ``--device`` names another device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def main(argv=None) -> dict:
    from mmt_psm_tpu_torch.tools import mt_lift_experiment as L

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    L.LIFT_MODEL = {**L.LIFT_MODEL, "compute_dtype": "float32"}
    results = L.main(argv)
    results["meta"].update(compute_dtype="float32", tf32=False)
    out = L.parse_args(argv).out
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
