"""The port's mean-teacher trainer: its switch between the supervised and
the mean-teacher step, the EMA gate and the hint adaptor's decay.

``build_mt_trainer`` at a 128 canvas in float32 on the CPU, the flagship
MT config (START_MT 1000, LAMBDA 5). The JAX side is the rule of
``mmt_psm_tpu/engine/trainer.py:85-99`` and ``train/supervised.py:83-91``:
supervised up to START_MT, the MT step past it; the teacher EMA only past
START_MT - 10, with alpha = min(1 - 1/(i+1), ALPHA) counted from there;
optax decays every trainable tensor, one without a gradient too
(``train/optim.py:105-107``). The parity of the step itself is
test_torch_port_mt_step.py's.
"""

import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu_torch.data.synthetic import generate_unlabeled_batch

U.setup_torch()

SUP = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "nms_loss", "loss_mask")
MT_KEYS = ("mt_classifier", "mt_fg_loss")


def test_trainer_switch_ema_gate_and_adaptor_decay(monkeypatch):
    """``build_mt_trainer``: on the card unless the caller asks for the CPU;
    a supervised step up to START_MT (even with an unlabeled batch), the MT
    step past it; the teacher untouched at START_MT - 10 and averaged from
    START_MT - 9 on (alpha = 1/2 at the EMA's first iteration); in a
    supervised step the hint adaptor, which gets no gradient, decays as
    optax decays it (weight by lr * WEIGHT_DECAY, bias not at all)."""
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch, unlabeled_to_torch
    from mmt_psm_tpu_torch.train import build_mt_trainer

    small = ["TPU.IMAGE_SIZE", 128, "TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
             "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
             "MODEL.RPN.PRE_NMS_TOP_N_TEST", 64, "MODEL.RPN.POST_NMS_TOP_N_TEST", 64,
             "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 64,
             # a decay of many ulps of the adaptor's weights in one step
             "SOLVER.BASE_LR", 0.05, "SOLVER.WEIGHT_DECAY", 0.01]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mt_trainer(opts=small)
    tr = build_mt_trainer(device="cpu", opts=small)
    assert tr.model.training and not tr.teacher.training
    assert not any(t.requires_grad for t in list(tr.teacher.parameters()) + list(tr.teacher.buffers()))
    lab = batch_to_torch(generate_batch(3, 2, image_size=128, max_instances=U.MAX_GT), "cpu")
    unl = unlabeled_to_torch(generate_unlabeled_batch(4, 2, image_size=128, max_instances=U.MAX_GT), "cpu")
    start = tr.mt.start_mt
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}  # noqa: E731

    tr.iteration = start - 10
    s0, t0 = sd(tr.model), sd(tr.teacher)
    lr = tr.optimizer.param_groups[0]["lr"]
    out = tr.step(lab, unl)
    assert "mt_weight" not in out and "mt_classifier" not in out
    assert all(torch.equal(v, t0[k]) for k, v in tr.teacher.state_dict().items())
    s1 = sd(tr.model)
    wd = tr.cfg.SOLVER.WEIGHT_DECAY
    for i in range(1, 6):
        w = f"hint_adaptor.adapter_{i}.weight"
        # optax: the decayed weight enters the momentum trace, lr scales it
        want = s0[w] - np.float32(lr) * (np.float32(wd) * s0[w])
        torch.testing.assert_close(s1[w], want, atol=1e-8, rtol=0.0)  # an ulp of the weight
        assert not torch.equal(s1[w], s0[w])
        assert torch.equal(s1[f"hint_adaptor.adapter_{i}.bias"], s0[f"hint_adaptor.adapter_{i}.bias"])

    out = tr.step(lab)  # iteration START_MT - 9: the EMA's first, alpha = 1/2
    s2 = tr.model.state_dict()
    for k, v in tr.teacher.state_dict().items():
        torch.testing.assert_close(v, 0.5 * t0[k] + 0.5 * s2[k], atol=1e-7, rtol=0.0)

    tr.iteration = start
    assert "mt_weight" not in tr.step(lab, unl)
    out = tr.step(lab, unl)  # START_MT + 1
    assert sorted(out) == sorted(SUP + MT_KEYS + ("loss_total", "mt_weight"))
    assert all(torch.isfinite(v) and not v.requires_grad for v in out.values())
    assert 0 < float(out["mt_weight"]) < tr.mt.lambda_
    assert tr.iteration == start + 2 and tr.scheduler.last_epoch == 4
