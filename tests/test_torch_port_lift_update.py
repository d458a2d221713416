"""The lift's update against the JAX package's: the SGD step, the learning
rate's schedule and the teacher's EMA of the mt and mgd arms, as
``tools/mt_lift_experiment.py`` builds them (``arm_steps`` on
``arm_config`` at the tool's defaults with ``--sharpen --hard-neg``: lr
2.5e-4, STEPS (1350,), 100 warm-up iterations, no clip, weight decay 5e-4,
bias lr x 2, momentum 0.9, START_MT 400, ALPHA 0.99).

The test step of test_torch_port_lift_steps.py cuts the update to a bare
backward; here the update runs whole, with the losses cut instead. Both
sides start from one state: the lift's student (the port's seeded init,
exported to the JAX layout), a teacher that differs from it in every
tensor, momentum in every trainable tensor, the optimizer's count and the
trainer's iteration both at the iteration (the lift's trainer starts at
0). Both take one gradient, seeded numbers in every tensor's JAX layout, as
the gradient of their losses: the port's step object runs its own
``step`` with its losses replaced by sum(g * tensor), whose gradient is g;
JAX runs its own jitted-step bodies (``make_supervised_step`` with the JAX
trainer's EMA gate, ``make_mt_step`` past START_MT, engine/trainer.py:85-91)
with a model whose loss is the same sum and ``unlabeled_losses`` giving
nothing, so ``tx.update``, ``optax.apply_updates`` and the EMA are JAX's own
code (mt_step.py:504-514). In a supervised step the hint adaptor has no
gradient in either package.

After the step, in float32: every tensor of the student, every momentum
buffer, the teacher, the learning rate, the optimizer's count and the
iteration, each within 1e-6 relative of JAX's, the scale being the
magnitude of the terms that make the element (p + lr (mu m + g + wd p)
for a weight, mu m + g + wd p for its momentum, alpha t + (1 - alpha) p
for the teacher). Iterations, for both arms: START_MT - 10 (390, no EMA
yet: the gate is iteration > 390), the first MT step (START_MT + 1), the
ramp's plateau (700) and each side of the schedule's step (1349, 1350);
for the mt arm also the first EMA (391).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_lift as PL
import torch_port_util as U
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu.train.optim import make_optimizer as jax_make_optimizer
from mmt_psm_tpu.train.supervised import create_train_state, make_supervised_step
from mmt_psm_tpu_torch.models import MaskRCNN
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params
from torch_port_variants import to_jax_flat

U.setup_torch()

ARGS = L.parse_args(["--sharpen", "--hard-neg", "--device", "cpu"])
PLATEAU = ARGS.start_mt + max(ARGS.iters // 6, 50)
ITERATIONS = (ARGS.start_mt - 10, ARGS.start_mt + 1, PLATEAU, 1349, 1350)
# the first EMA is at START_MT - 9 (the gate is iteration > START_MT - 10)
CASES = [("mt", ARGS.start_mt - 9)] + [(arm, it) for arm in ("mt", "mgd") for it in ITERATIONS]
RTOL = 1e-6


@pytest.fixture(scope="module")
def base():
    """The lift's student, a teacher, a gradient and momentum in the JAX
    layout (and the last three in the port's); the port model holding the
    student."""
    _, tc = PL.lift_configs(64, with_hint=True)
    tm = MaskRCNN(tc).init_weights(torch.Generator().manual_seed(0))
    flat = to_jax_flat(tm, (tc.backbone_out_channels, tc.box_pooler_resolution, tc.box_pooler_resolution))
    rng = np.random.default_rng(12)
    noise = lambda v, s: rng.normal(0.0, s, v.shape).astype(np.float32)  # noqa: E731
    # the init's FrozenBN statistics are the identity: random ones, a positive variance
    for k, v in flat.items():
        if "bn" in k and k.endswith((".running_var", ".weight")):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif "bn" in k and k.endswith((".running_mean", ".bias")):
            flat[k] = noise(v, 0.1)
    load_jax_params(tm, flat)
    b = {"tm": tm, "flat": flat, "teacher": {k: v + noise(v, 0.01) for k, v in flat.items()},
         "grads": {k: noise(v, 0.05) for k, v in flat.items()},
         "momentum": {k: noise(v, 0.05) for k, v in flat.items()}}
    b["port"] = {key: {n: U.port_grad_of(n, b[key]) for n in tm.state_dict()}
                 for key in ("teacher", "grads", "momentum")}
    return b


class _ReplayModel:
    """Stands in for the flax model in JAX's step functions: its losses are
    the replay sum(g * param), whose gradient is g."""

    def __init__(self, grads):
        self.grads = grads

    def apply(self, variables, *args, **kwargs):
        terms = jax.tree_util.tree_map(lambda g, p: jnp.sum(g * p), self.grads, variables["params"])
        return {"loss_replay": sum(jax.tree_util.tree_leaves(terms))}


def _jax_step(b, arm, it, monkeypatch):
    """JAX's step at iteration ``it`` from the shared state: the new
    params, teacher and momentum as flat numpy maps, the step, the count,
    the learning rate before and after."""
    jcfg = PL.jax_arm_cfg(L.arm_config(ARGS, arm))
    jmt = J.MTConfig.from_cfg(jcfg)
    params = U.unflatten(b["flat"])
    tx, schedule = jax_make_optimizer(jcfg, params)
    grads = b["grads"]
    use_mt = it > jmt.start_mt and jmt.lambda_ > 0
    if not use_mt:  # a supervised step does not reach the MGD adaptor
        grads = {k: (np.zeros_like(v) if k.startswith("hint_adaptor/") else v) for k, v in grads.items()}
    model = _ReplayModel(U.unflatten(grads))
    state = create_train_state(params, tx, with_teacher=True)
    opt_state = optax.tree_utils.tree_set(state.opt_state, trace=U.unflatten(b["momentum"]),
                                          count=jnp.asarray(it, jnp.int32))
    state = state.replace(opt_state=opt_state, step=jnp.asarray(it, jnp.int32),
                          teacher_params=U.unflatten(b["teacher"]))
    zeros = jnp.zeros((1, 1, 4), jnp.float32)
    labeled = {"image": zeros, "image_size": zeros, "boxes": zeros, "labels": zeros[..., 0],
               "gt_valid": zeros[..., 0]}
    rng = jax.random.PRNGKey(0)
    if use_mt:
        monkeypatch.setattr(J, "unlabeled_losses", lambda *a, **k: {})
        new, _ = J.make_mt_step(model, tx, jmt)(state, labeled, {"t_images": zeros}, rng)
    else:
        # the JAX trainer's supervised step and its EMA gate (engine/trainer.py:85-90)
        ema_start = (jmt.start_mt - 10) if jmt.lambda_ > 0 else None
        new, _ = make_supervised_step(model, tx, ema_alpha=jmt.alpha, ema_start=ema_start)(state, labeled, rng)
    as_np = lambda tree: U.flatten(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    count = int(optax.tree_utils.tree_get(new.opt_state, "count"))
    return {"params": as_np(new.params), "teacher": as_np(new.teacher_params), "step": int(new.step),
            "momentum": as_np(optax.tree_utils.tree_get(new.opt_state, "trace")), "count": count,
            "lr": float(schedule(count)), "lr_used": float(schedule(it)), "jmt": jmt, "use_mt": use_mt}


def _port_step(b, arm, it):
    """The port's step object of the arm (``arm_steps``), brought to the
    shared state at iteration ``it``, after its own ``step`` on the
    replayed gradient; the student's tensors before the step."""
    port = b["port"]
    steps = L.arm_steps(b["tm"], L.arm_config(ARGS, arm))
    load_jax_params(steps.teacher, b["teacher"])
    steps.iteration = it
    with warnings.catch_warnings():  # the count advanced without optimizer steps
        warnings.simplefilter("ignore")
        for _ in range(it):
            steps.scheduler.step()
    names = {id(p): n for n, p in steps.model.named_parameters()}
    for p in steps.trainable:
        steps.optimizer.state[p]["momentum_buffer"] = torch.from_numpy(port["momentum"][names[id(p)]].copy())
    use_mt = steps.use_mt({"t_images": None})
    tensors = [(n, t) for n, t in list(steps.model.named_parameters()) + list(steps.model.named_buffers())
               if t.requires_grad and (use_mt or not n.startswith("hint_adaptor."))]
    assert {id(t) for _, t in tensors} <= {id(t) for t in steps.clip_tensors}

    def replay(*_a, **_k):
        return {"loss_replay": sum((torch.from_numpy(port["grads"][n]) * t).sum() for n, t in tensors)}

    before = {k: v.detach().numpy().copy() for k, v in steps.model.state_dict().items()}
    labeled = {k: torch.zeros(1, 1, 4) for k in ("image", "image_size", "boxes")}
    labeled.update(labels=torch.zeros(1, 1), gt_valid=torch.zeros(1, 1, dtype=torch.bool))
    if use_mt:
        steps.mt_losses = replay
    else:
        steps.model.forward_train = replay
    steps.step(labeled, {"t_images": None})
    return steps, before, use_mt


@pytest.mark.parametrize("arm,it", CASES)
def test_update_matches_optax_and_ema(base, arm, it, monkeypatch):
    want = _jax_step(base, arm, it, monkeypatch)
    steps, before, use_mt = _port_step(base, arm, it)
    port = base["port"]
    assert use_mt == want["use_mt"] == (it > ARGS.start_mt)
    assert steps.iteration == want["step"] == it + 1
    assert steps.scheduler.last_epoch == want["count"] == it + 1
    cfg = steps.cfg.SOLVER
    for group, factor in zip(steps.optimizer.param_groups, (1.0, cfg.BIAS_LR_FACTOR)):
        np.testing.assert_allclose(group["lr"], want["lr"] * factor, rtol=RTOL)
    jmt = want["jmt"]
    ema = it > jmt.start_mt - 10
    alpha = float(min(1.0 - 1.0 / (it - (jmt.start_mt - 10) + 1.0), jmt.alpha)) if ema else 1.0
    trainable = {id(p) for p in steps.trainable}
    named = dict(steps.model.named_parameters())
    moved = 0
    teacher_sd = steps.teacher.state_dict()
    for name, value in steps.model.state_dict().items():
        p0, got, exp = before[name], value.numpy(), U.port_grad_of(name, want["params"])
        if name in named and id(named[name]) in trainable:
            g = port["grads"][name] if use_mt or not name.startswith("hint_adaptor.") else 0.0
            bias = name.endswith(".bias")
            wd = cfg.WEIGHT_DECAY_BIAS if bias else cfg.WEIGHT_DECAY
            terms = cfg.MOMENTUM * np.abs(port["momentum"][name]) + np.abs(g) + wd * np.abs(p0)
            lr = want["lr_used"] * (cfg.BIAS_LR_FACTOR if bias else 1.0)
            _assert_rel(got, exp, np.abs(p0) + lr * terms, f"{arm} @{it} student {name}")
            buf = steps.optimizer.state[named[name]]["momentum_buffer"].numpy()
            _assert_rel(buf, U.port_grad_of(name, want["momentum"]), terms, f"{arm} @{it} momentum {name}")
            assert np.any(got != p0), name
            moved += 1
        else:  # frozen: neither package moves it
            np.testing.assert_array_equal(got, p0, err_msg=name)
            np.testing.assert_array_equal(exp, p0, err_msg=name)
        t_got, t0 = teacher_sd[name].numpy(), port["teacher"][name]
        _assert_rel(t_got, U.port_grad_of(name, want["teacher"]), alpha * np.abs(t0) + (1.0 - alpha) * np.abs(exp),
                    f"{arm} @{it} teacher {name}")
        if not ema:
            np.testing.assert_array_equal(t_got, t0, err_msg=f"the teacher's {name} moved before the EMA's start")
    assert moved == len(steps.trainable) > 80


def _assert_rel(got, want, scale, what):
    # float32: the difference of two float32 numbers this close is exact
    err = np.abs(got - want)
    bound = np.float32(RTOL) * np.asarray(scale, np.float32)
    worst = float((err - bound).max())
    assert worst <= 0, f"{what}: max err {err.max():.3g} beyond {RTOL} of its terms (at most {bound.max():.3g})"
