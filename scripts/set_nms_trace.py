"""Where the set-NMS graph's float32 detections with the kernels part from
those with the plain versions: stage by stage, each stage fed the same
inputs.

    python3 scripts/set_nms_trace.py [--seeds 1] [--variant set_nms]

For each seed: the graph ``--variant`` names in
``mmt_psm_tpu_torch/models/variants.py`` (1024 canvas, float32, TF32 off),
seeded weights, on ``chip_smoke.py``'s float32 batch (the batch of
``scripts/flagship_f32_seeds.py``). The stages of ``detections_from_features``
run once with the plain versions; then each stage that holds a kernel runs
again with the kernel on the plain run's inputs to that stage, and the
stages after it are fed each run's own outputs:

* ``rpn``: ``select_proposals`` with K1 against the plain flags, on the
  same RPN outputs (and K1's flags against the plain ones on the same
  score-sorted boxes of each level);
* ``box_head``: ``box_forward`` with K2 on the same proposals;
* ``postprocess``: the post-processor on each box head's outputs: which
  slots differ, and the scores of the detections that trade places;
* ``mask_head``: ``mask_forward`` with K2 on the same detections.

Prints one JSON line a seed. Needs one card.
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
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--variant", type=str, default="set_nms")
    args = ap.parse_args()
    from mmt_psm_tpu_torch.models import rpn as R
    from mmt_psm_tpu_torch.models.box_head import postprocess_boxes
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

    def plain(on: bool):
        """The plain versions of K1 and K2 in place of the kernels (or not)."""
        return mock.patch.multiple(N, suppress_cuda=N.suppress_plain if on else N.suppress_cuda), \
            mock.patch.object(Pm, "multilevel_roi_align_cuda",
                              Pm.multilevel_roi_align_plain if on else Pm.multilevel_roi_align_cuda)

    def run(fn, use_plain, *a):
        p1, p2 = plain(use_plain)
        with torch.no_grad(), p1, p2:
            return fn(*a)

    def maxdiff(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    for seed in args.seeds:
        model = model_from_cfg(variant_config(args.variant, ["TPU.COMPUTE_DTYPE", "float32"]), dev, seed=seed)
        c = model.config
        feats = run(model.backbone_features, True, x)
        obj, reg = run(model.rpn, True, feats)

        def proposals(use_plain):
            return run(lambda: R.select_proposals(obj, reg, model.anchors, sizes, pre_nms_top_n=c.pre_nms_top_n_test,
                                                  post_nms_top_n=c.post_nms_top_n_test,
                                                  fpn_post_nms_top_n=c.fpn_post_nms_top_n_test,
                                                  nms_thresh=c.rpn_nms_thresh, min_size=c.rpn_min_size), use_plain)

        # K1's flags on the same score-sorted boxes: every call select_proposals makes
        calls, kernel = [], N.suppress_cuda

        def recording(boxes_s, valid_s, thr):
            flags = kernel(boxes_s, valid_s, thr)
            calls.append((boxes_s.clone(), valid_s.clone(), thr.clone(), flags))
            return flags

        recording.launches = 0  # the wrapper counts its launches on the name it is called by

        with mock.patch.object(N, "suppress_cuda", recording), torch.no_grad():
            R.select_proposals(obj, reg, model.anchors, sizes, pre_nms_top_n=c.pre_nms_top_n_test,
                               post_nms_top_n=c.post_nms_top_n_test, fpn_post_nms_top_n=c.fpn_post_nms_top_n_test,
                               nms_thresh=c.rpn_nms_thresh, min_size=c.rpn_min_size)
        k1_flags_differ = sum(int((f != N.suppress_plain(b, v, t)).sum()) for b, v, t, f in calls)
        p_plain, p_kern = proposals(True), proposals(False)
        row = {"graph": args.variant, "seed": seed,
               "rpn": {"k1_calls": len(calls), "k1_flags_differ": k1_flags_differ,
                       "proposals_valid_equal": bool(torch.equal(p_plain.valid, p_kern.valid)),
                       "proposal_boxes_max_diff": maxdiff(p_plain.boxes, p_kern.boxes)}}
        box_plain = run(model.box_forward, True, feats, p_plain.boxes)
        box_kern = run(model.box_forward, False, feats, p_plain.boxes)
        row["box_head"] = {"logits_max_diff": maxdiff(box_plain[0], box_kern[0]),
                           "deltas_max_diff": maxdiff(box_plain[1], box_kern[1])}

        def post(out):
            with torch.no_grad():
                return postprocess_boxes(out[0], out[1], p_plain, sizes, num_classes=c.num_classes,
                                         score_thresh=c.score_thresh, nms_thresh=c.nms_thresh,
                                         detections_per_img=c.detections_per_img, reg_weights=c.reg_weights,
                                         nms_type=c.nms_type)

        d_plain, d_kern = post(box_plain), post(box_kern)
        slots = (d_plain.boxes - d_kern.boxes).abs().amax(-1) > 1e-3
        swapped = []
        for b_i, s_i in slots.nonzero().tolist()[:8]:
            # where the other run put this slot's detection, by its proposal and class
            key = (d_plain.head_ids[b_i, s_i], d_plain.labels[b_i, s_i]) if d_plain.head_ids is not None else None
            other = None
            if key is not None:
                hit = ((d_kern.head_ids[b_i] == key[0]) & (d_kern.labels[b_i] == key[1])).nonzero().flatten()
                other = int(hit[0]) if len(hit) else None
            swapped.append({"image": b_i, "slot": s_i, "label": int(d_plain.labels[b_i, s_i]),
                            "score_plain": float(d_plain.scores[b_i, s_i]),
                            "score_kernel": float(d_kern.scores[b_i, s_i]), "slot_in_kernel_run": other,
                            "score_plain_next": float(d_plain.scores[b_i, min(s_i + 1, d_plain.scores.shape[1] - 1)])})
        row["postprocess"] = {
            "same_valid_labels": bool(torch.equal(d_plain.valid, d_kern.valid)
                                      and torch.equal(d_plain.labels, d_kern.labels)),
            "same_order": bool(d_plain.head_ids is None or torch.equal(d_plain.head_ids, d_kern.head_ids)),
            "slots_with_other_boxes": int(slots.sum()), "boxes_max_diff": maxdiff(d_plain.boxes, d_kern.boxes),
            "scores_max_diff": maxdiff(d_plain.scores, d_kern.scores), "first_slots": swapped}
        m_plain = run(model.mask_forward, True, feats, d_plain.boxes)[0]
        m_kern = run(model.mask_forward, False, feats, d_plain.boxes)[0]
        row["mask_head"] = {"logits_max_diff": maxdiff(m_plain, m_kern)}
        print(json.dumps(row), flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
