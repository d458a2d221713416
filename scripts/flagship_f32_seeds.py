"""The f32 flagship forward with the kernels against the plain versions,
over seeded weights, with the mask relation module (CIAM) and without.

    python3 scripts/flagship_f32_seeds.py [--seeds 0 1 2 3 4 5] [--variant NAME]

For each seed: the flagship (``configs/pap/mmt_psm_r50_fpn.yaml``, or the
graph ``--variant`` names in ``mmt_psm_tpu_torch/models/variants.py``; 1024
canvas, float32, TF32 off) on ``chip_smoke.py``'s f32 batch; the largest
|difference| of boxes, scores and mask probabilities between two runs with
the kernels, between the kernels and the plain versions of K1 and K2, the
same with CIAM skipped (where the graph has it), and the valid detections. The kernels differ from
the plain versions by float32 summation order only; this says where a
model's weights amplify that. Needs one card.
"""

import argparse
import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    ap.add_argument("--variant", type=str, default=None)
    args = ap.parse_args()
    from mmt_psm_tpu_torch import build_model
    from mmt_psm_tpu_torch.models.detector import model_from_cfg
    from mmt_psm_tpu_torch.models.variants import variant_config
    from mmt_psm_tpu_torch.ops import kernels
    from mmt_psm_tpu_torch.ops import nms as N
    from mmt_psm_tpu_torch.ops import pooler as Pm
    from mmt_psm_tpu_torch.utils.env import card_line

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    kernels.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, 1024, 1024, 3, generator=gen, device=dev) * 40.0
    sizes = torch.tensor([[1024, 1024], [900, 1000]], dtype=torch.int32).to(dev)

    def run(model, plain):
        with torch.no_grad(), \
                mock.patch.object(N, "suppress_cuda", N.suppress_plain if plain else N.suppress_cuda), \
                mock.patch.object(Pm, "multilevel_roi_align_cuda",
                                  Pm.multilevel_roi_align_plain if plain else Pm.multilevel_roi_align_cuda):
            return model(x, sizes)

    def diff(a, b):
        out = {k: float((getattr(a, k) - getattr(b, k)).abs().max()) for k in ("boxes", "scores", "masks")}
        out["same_valid_labels"] = bool(torch.equal(a.valid, b.valid) and torch.equal(a.labels, b.labels))
        return out

    for seed in args.seeds:
        f32 = ["TPU.COMPUTE_DTYPE", "float32"]
        model = (build_model(device=dev, seed=seed, opts=f32) if args.variant is None
                 else model_from_cfg(variant_config(args.variant, f32), dev, seed=seed))
        k1, k2, p = run(model, False), run(model, False), run(model, True)
        row = {"graph": args.variant or "flagship", "seed": seed, "valid": int(k1.valid.sum()),
               "kernels_twice": diff(k1, k2), "kernels_vs_plain": diff(k1, p)}
        if model.config.with_relation_mask:
            with mock.patch.object(type(model), "refine_masks", lambda self, logits, feats, labels, valid: logits):
                row["kernels_vs_plain_without_ciam"] = diff(run(model, False), run(model, True))
        print(json.dumps(row), flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
