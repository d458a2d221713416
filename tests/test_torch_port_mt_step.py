"""The port's mean-teacher step against the JAX package's.

Flagship graph with the MGD hint adaptor at a 128 canvas in float32 on the
CPU, the train counts cut to ``torch_port_util.TRAIN_SMALL`` (no dropout),
the same student weights (hint adaptor included) on both sides, a teacher
whose hint adaptor differs from the student's, the same sampler draws for
the supervised and the teacher's subsampling
(``torch_port_util.same_draws``) and the relation head's geometric gate
off its pole (WG bias 5, as in test_torch_port_train_step.py). The MT
config is the flagship's (LAMBDA 5, CLS_LOSS 0.2, FG_HINT 1, AUG_K 2,
AUG_S 1):

* ``unlabeled_losses`` (PSM, MGD) and the six supervised losses within
  1e-4 relative of the JAX ``unlabeled_losses`` and ``forward_train``;
* the gradient of the weighted total w.r.t. every student tensor within
  1e-3 of its largest |JAX gradient| + 1e-6, or within JAX's own spread
  when the labeled and the student's images carry 1e-5 relative noise.
  The weights are those of the ramp's plateau (START_MT + RAMPUP_STEP,
  weight LAMBDA), where PSM counts 1 and MGD 5 against six supervised
  losses of 1: just past START_MT the ramp weighs them ~0.007 and ~0.035,
  and an error in their backward would hide under the tolerance;
* the gradient of the weighted MT losses alone, held the same way;
* one ``MTTrainer.step`` at iteration START_MT + 1, held by parts: its
  update on the JAX gradients (clip, SGD, EMA at iteration 11 of the EMA)
  against optax's chain and ``ema_update`` on the same gradients (the
  whole jitted JAX step compiles for minutes on the CPU), deltas within 2e-5 of their largest |delta| +
  four ulps, the teacher within four ulps plus the delta's bound.

The trainer's switch is held in test_torch_port_mt_trainer.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu.train.ema import ema_update as j_ema_update
from mmt_psm_tpu.train.optim import make_optimizer as jax_make_optimizer
from mmt_psm_tpu.utils.torch_import import convert_state_dict
from mmt_psm_tpu_torch.config import get_cfg
from mmt_psm_tpu_torch.data.synthetic import generate_unlabeled_batch
from mmt_psm_tpu_torch.models.layers import FrozenBatchNorm2d
from mmt_psm_tpu_torch.train import MTTrainer
from mmt_psm_tpu_torch.train import mt_step as P
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

U.setup_torch()

WG_BIAS = 5.0
NOISE = 1e-5
STEP = 1001  # START_MT + 1: the trainer step
GRAD_STEP = 1250  # START_MT + RAMPUP_STEP: the MT losses at full weight
SUP = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "nms_loss", "loss_mask")
MT_KEYS = ("mt_classifier", "mt_fg_loss")


def _cfgs():
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(U.FLAGSHIP)
    tcfg = get_cfg()
    tcfg.merge_from_file(U.FLAGSHIP)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = _cfgs()
    jmt, pmt = J.MTConfig.from_cfg(jcfg), P.MTConfig.from_cfg(tcfg)
    assert GRAD_STEP == jmt.start_mt + jmt.rampup_step
    assert float(J.mt_loss_weight(jnp.asarray(GRAD_STEP), jmt)) == jmt.lambda_
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, _, tm, flat = U.build_pair(**U.TRAIN_SMALL, with_hint_adaptor=True)
        flat["relation_nms/relation_module/WG.bias"] = np.full_like(flat["relation_nms/relation_module/WG.bias"],
                                                                   WG_BIAS)
        flat_t = dict(flat)
        rng = np.random.default_rng(7)
        for k in flat_t:
            if k.startswith("hint_adaptor/"):
                flat_t[k] = (flat[k] + rng.normal(0.0, 0.02, flat[k].shape)).astype(np.float32)
        load_jax_params(tm, flat)
        teacher = U.MaskRCNN(tm.config)
        load_jax_params(teacher, flat_t)
        teacher.eval().requires_grad_(False)
        batch = U.train_batch()
        ub = generate_unlabeled_batch(5, 2, image_size=128, max_instances=U.MAX_GT)
        gt = U.jax_gt(batch)
        t_params = U.unflatten(flat_t)

        def loss_fn(p, image, s_images):
            sup = jm.apply({"params": p}, image, jnp.asarray(batch["image_size"]), gt, train=True,
                           rngs={"sample": jax.random.PRNGKey(0)})
            unl = {"t_images": jnp.asarray(ub["t_images"]), "s_images": s_images,
                   "image_size": jnp.asarray(ub["image_size"])}
            mt = J.unlabeled_losses(jm, p, t_params, unl, jax.random.PRNGKey(1), jmt)
            all_losses = {**sup, **mt}
            weighted = J.weight_sum_losses(all_losses, jnp.asarray(GRAD_STEP, jnp.int32), jmt)
            mt = sum(weighted[k] for k in MT_KEYS)
            return (sum(v for k, v in weighted.items() if k not in MT_KEYS), mt), all_losses

        @jax.jit
        def grad_fn(p, image, s_images):
            """The weighted total, the losses, and the gradients of the
            weighted total and of the weighted MT losses alone."""
            (sup, mt), pull, all_losses = jax.vjp(lambda q: loss_fn(q, image, s_images), p, has_aux=True)
            one, zero = jnp.ones_like(mt), jnp.zeros_like(mt)
            return sup + mt, all_losses, pull((one, one))[0], pull((zero, one))[0]

        params = U.unflatten(flat)
        j_total, j_losses, j_grads, j_mt_grads = grad_fn(params, batch["image"], ub["s_images"])
        noise = np.random.default_rng(1)
        noisy = lambda x: (x * (1 + NOISE * noise.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
        _, _, j_grads_noisy, j_mt_grads_noisy = grad_fn(params, noisy(batch["image"]), noisy(ub["s_images"]))

        tm.train()
        trainer = MTTrainer(tm, teacher, tcfg, torch.Generator())
        losses = trainer.mt_losses({k: U.t(v) for k, v in batch.items()}, {k: U.t(v) for k, v in ub.items()})
        weighted = P.weight_sum_losses(losses, GRAD_STEP, pmt)
        mt_grads = torch.autograd.grad(sum(weighted[k] for k in MT_KEYS), [x for _, x in _named_grad_tensors(tm)],
                                       retain_graph=True, allow_unused=True)
        total = sum(weighted.values())
        total.backward()
    as_np = lambda g: U.flatten(jax.tree_util.tree_map(np.asarray, g))  # noqa: E731
    return {"tm": tm, "teacher": teacher, "flat": flat, "flat_t": flat_t, "trainer": trainer, "losses": losses,
            "total": total, "j_total": float(j_total), "j_losses": j_losses, "jmt": jmt, "jcfg": jcfg,
            "tcfg": tcfg, "j_grads": as_np(j_grads), "j_grads_noisy": as_np(j_grads_noisy), "mt_grads": mt_grads,
            "j_mt_grads": as_np(j_mt_grads), "j_mt_grads_noisy": as_np(j_mt_grads_noisy)}


def test_losses_match_jax(run):
    got, want = run["losses"], run["j_losses"]
    assert sorted(got) == sorted(want) == sorted(SUP + MT_KEYS)
    for k in SUP + MT_KEYS:
        w = float(want[k])
        assert np.isfinite(w) and w > 0, (k, w)
        U.assert_close(got[k].detach(), w, atol=0.0, rtol=1e-4, what=k)
    U.assert_close(run["total"].detach(), run["j_total"], atol=0.0, rtol=1e-4, what="weighted total")


def _named_grad_tensors(tm):
    out = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    out += [(n, b) for n, b in tm.named_buffers() if b.requires_grad]
    return out


def test_every_gradient_matches_jax(run):
    named = _named_grad_tensors(run["tm"])
    assert {id(t) for _, t in named} == {id(t) for t in run["trainer"].clip_tensors}
    assert sum(n.startswith("hint_adaptor.") for n, _ in named) == 10
    by_spread = []
    for name, tensor in named:
        want = U.port_grad_of(name, run["j_grads"])
        spread = float(np.abs(U.port_grad_of(name, run["j_grads_noisy"]) - want).max())
        strict = 1e-3 * float(np.abs(want).max())
        assert tensor.grad is not None, name
        U.assert_close(tensor.grad, want, atol=max(strict, spread) + 1e-6, what=name)
        if float(np.abs(tensor.grad.numpy() - want).max()) > strict + 1e-6:
            by_spread.append(name)
        if name.startswith("hint_adaptor.") and name.endswith("weight"):
            assert np.abs(want).max() > 0, name  # MGD reaches every level's adaptor
    assert len(by_spread) <= 4, by_spread


def test_mt_loss_gradients_match_jax(run):
    """The gradient of the weighted MT losses alone (PSM and MGD at the
    ramp's plateau) w.r.t. every student tensor, held as the total's: the
    student box head's through PSM, the backbone's through K3's adjoint and
    MGD, the hint adaptor's. A tensor they do not reach has no port
    gradient and an all-zero JAX one."""
    reached, by_spread = [], []
    for (name, _), got in zip(_named_grad_tensors(run["tm"]), run["mt_grads"]):
        want = U.port_grad_of(name, run["j_mt_grads"])
        if got is None:
            assert not np.any(want), name
            continue
        spread = float(np.abs(U.port_grad_of(name, run["j_mt_grads_noisy"]) - want).max())
        strict = 1e-3 * float(np.abs(want).max())
        U.assert_close(got, want, atol=max(strict, spread) + 1e-6, what=f"MT gradient of {name}")
        if float(np.abs(got.numpy() - want).max()) > strict + 1e-6:
            by_spread.append(name)
        if np.any(want):
            reached.append(name)
    for prefix in ("roi_heads.box.feature_extractor.fc6.", "roi_heads.box.predictor.cls_score.",
                   "backbone.fpn.", "backbone.body.layer4.", "hint_adaptor."):
        assert any(n.startswith(prefix) for n in reached), prefix
    assert not any(n.startswith(("rpn.", "roi_heads.mask.")) for n in reached), reached
    assert len(by_spread) <= 4, by_spread


def test_hint_embeddings_and_weight_round_trip(run):
    """The adaptor's state names load from and convert back to the JAX
    ``hint_adaptor/adapter_N`` parameters, and its embeddings equal JAX's."""
    sd = {k: v.detach().numpy() for k, v in run["tm"].state_dict().items()}
    back = convert_state_dict(sd)
    assert "__unmatched__" not in back and set(back) == set(run["flat"])
    for k in back:
        if k.startswith("hint_adaptor/"):
            np.testing.assert_array_equal(back[k], run["flat"][k], err_msg=k)
    from mmt_psm_tpu.models import MaskRCNN as JM

    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(2, h, h, 256)).astype(np.float32) for h in (32, 16, 8, 4, 2)]
    jm, _ = U.configs(with_hint_adaptor=True)
    want = JM(config=jm).apply({"params": U.unflatten(run["flat"])}, [jnp.asarray(f) for f in feats],
                               method=JM.hint_embeddings)
    with torch.no_grad():
        got = run["tm"].hint_embeddings([U.t(f) for f in feats])
    for g, w in zip(got, want):
        U.assert_close(g, w, atol=1e-5, what="hint embedding")


def _replay(tm, j_grads):
    total = 0.0
    for name, tensor in _named_grad_tensors(tm):
        total = total + (U.t(U.port_grad_of(name, j_grads)) * tensor).sum()
    return {"loss_total_replay": total}


def test_one_mt_step_update_matches_optax_and_ema(run, monkeypatch):
    """The update of one MT step at iteration START_MT + 1 on the JAX
    gradients: optax's chain from a fresh state (the learning rate at its
    warm-up start: the optimizer's count is 0, the trainer's iteration is
    1001), then the EMA at iteration 11 of the EMA."""
    jmt, flat = run["jmt"], run["flat"]
    params, t_params, grads = U.unflatten(flat), U.unflatten(run["flat_t"]), U.unflatten(run["j_grads"])
    tx, _ = jax_make_optimizer(run["jcfg"], params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    j_teacher = j_ema_update(t_params, new_params, jnp.asarray(STEP - (jmt.start_mt - 10)), jmt.alpha)
    updates = U.flatten(jax.tree_util.tree_map(np.asarray, updates))
    j_teacher = U.flatten(jax.tree_util.tree_map(np.asarray, j_teacher))

    tm = U.MaskRCNN(run["tm"].config)
    load_jax_params(tm, flat)
    teacher = copy.deepcopy(run["teacher"])
    trainer = MTTrainer(tm, teacher, run["tcfg"], torch.Generator())
    trainer.iteration = STEP
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    monkeypatch.setattr(trainer, "mt_losses", lambda *a: _replay(tm, run["j_grads"]))
    out = trainer.step({}, {"t_images": None})
    assert trainer.iteration == STEP + 1 and trainer.scheduler.last_epoch == 1
    U.assert_close(out["mt_weight"], float(J.mt_loss_weight(jnp.asarray(STEP), jmt)), atol=1e-6, what="mt_weight")

    frozen_bn = {n for n, m in tm.named_modules() if isinstance(m, FrozenBatchNorm2d)}
    moved = 0
    for name, value in tm.state_dict().items():
        delta = (value - before[name]).numpy()
        frozen = name.rsplit(".", 1)[0] in frozen_bn or name.startswith(("backbone.body.stem.",
                                                                          "backbone.body.layer1."))
        tol = 0.0
        if frozen:
            assert not np.any(delta), name
        else:
            want = U.port_grad_of(name, updates)
            ulp = float(np.spacing(np.abs(before[name].numpy()).max()))
            tol = 2e-5 * float(np.abs(want).max()) + 4 * ulp
            U.assert_close(delta, want, atol=tol, what=name)
            moved += 1
        # the EMA covers every tensor of the JAX param tree, frozen ones too;
        # the student's delta reaches it times 1 - alpha < 1
        t_new = teacher.state_dict()[name].numpy()
        ulp = float(np.spacing(np.abs(t_new).max()))
        U.assert_close(t_new, U.port_grad_of(name, j_teacher), atol=4 * ulp + tol, what=f"teacher {name}")
    assert moved > 100
