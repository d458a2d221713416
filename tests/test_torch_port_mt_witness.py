"""Whether the port's losses grow faster than JAX's: both packages' gradients
at the state where the port's witness run has grown, with the same draws.

``scripts/mt_divergence_witness.py`` (CPU, 128 px, f32, batch 2, the
flagship's training graph at its full counts, one init) found the port's
``loss_box_reg`` peaking higher than JAX's over 40 MT steps on one repeated
batch pair, each package drawing its own samples. Here the port takes the
witness's first 30 steps (seed 0, four threads); then, at that student and
teacher, both packages compute one MT step's losses and the gradient of its
weighted total (iteration START_MT + 31, the ramp's weight there) with the
same sampler draws (``torch_port_util.same_draws``) and no box-head dropout
(its masks come from each package's own generator). JAX's own spread is
its largest move over NOISE_DRAWS copies of the three image inputs
(labeled, student and teacher views) with NOISE relative noise. Held as
tests/test_torch_port_mt_step.py holds one step at the init, JAX's spread
included: each loss within 1e-4 relative or JAX's own move, every gradient
within 1e-3 of its largest |JAX gradient| + 1e-6 or JAX's spread, and the
global gradient norm within the range of JAX's noisy ones. The state is far
worse conditioned than the init (measured: JAX's global gradient norm
7565-22127 over five noisy copies against 10640; 240 tensors past the 1e-3
bound, every one within the spread), so no count of tensors held by the
spread is asserted. ``loss_box_reg``, the loss the witness saw peak higher
in the port, agrees within 1e-6. A slow test: ~17 minutes.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.models import MaskRCNN as JaxMaskRCNN
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu.utils.torch_import import convert_state_dict
from mmt_psm_tpu_torch.models import MaskRCNN
from mmt_psm_tpu_torch.models.detector import load_config
from mmt_psm_tpu_torch.train import MTTrainer
from mmt_psm_tpu_torch.train import mt_step as P
from mmt_psm_tpu_torch.utils.jax_params import flax_key

sys.path.insert(0, os.path.join(U.REPO, "scripts"))
import mt_divergence_witness as W  # noqa: E402

WITNESS_STEPS = 30
NOISE, NOISE_DRAWS = 1e-5, 5
LOSS_RTOL = 1e-4
MT_KEYS = ("mt_classifier", "mt_fg_loss")

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    lab, unl = W.first_batches(W.OPTS)
    jcfg, jm, params = W.jax_init(W.OPTS, lab)
    flat = U.flatten(jax.tree_util.tree_map(np.asarray, params))
    trainer = W.port_trainer(W.OPTS, flat, seed=0)
    record = W.run_port(W.OPTS, lab, unl, WITNESS_STEPS, flat, 0, trainer=trainer)
    assert record["first_non_finite"] is None, record
    iteration = trainer.iteration
    student = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    teacher_sd = {k: v.detach().clone() for k, v in trainer.teacher.state_dict().items()}
    del trainer
    # the state in the JAX layout (the hint adaptor's too)
    j_student = convert_state_dict({k: v.numpy() for k, v in student.items()})
    j_teacher = convert_state_dict({k: v.numpy() for k, v in teacher_sd.items()})
    assert "__unmatched__" not in j_student and set(j_student) == set(flat)

    jmodel = JaxMaskRCNN(config=dataclasses.replace(jm.config, box_head_dropout=0.0))
    jmt = J.MTConfig.from_cfg(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=W.BATCH)
        gt = U.jax_gt(lab)
        t_params = U.unflatten(j_teacher)

        def loss_fn(p, image, s_images, t_images):
            sup = jmodel.apply({"params": p}, image, jnp.asarray(lab["image_size"]), gt, train=True,
                               rngs={"sample": jax.random.PRNGKey(0)})
            ub = {"t_images": t_images, "s_images": s_images, "image_size": jnp.asarray(unl["image_size"])}
            mt = J.unlabeled_losses(jmodel, p, t_params, ub, jax.random.PRNGKey(1), jmt)
            weighted = J.weight_sum_losses({**sup, **mt}, jnp.asarray(iteration, jnp.int32), jmt)
            return sum(weighted.values()), {**sup, **mt}

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        p0 = U.unflatten(j_student)
        (j_total, j_losses), j_grads = grad_fn(p0, lab["image"], unl["s_images"], unl["t_images"])
        j_grads = U.flatten(jax.tree_util.tree_map(np.asarray, j_grads))
        j_losses = {k: float(v) for k, v in j_losses.items()}
        spread = {k: 0.0 for k in j_grads}
        loss_spread = {k: 0.0 for k in j_losses}
        norms = []
        noise = np.random.default_rng(1)
        noisy = lambda x: (x * (1 + NOISE * noise.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
        for _ in range(NOISE_DRAWS):
            (_, n_losses), n_grads = grad_fn(p0, noisy(lab["image"]), noisy(unl["s_images"]), noisy(unl["t_images"]))
            n_grads = U.flatten(jax.tree_util.tree_map(np.asarray, n_grads))
            for k in spread:
                spread[k] = max(spread[k], float(np.abs(n_grads[k] - j_grads[k]).max(initial=0.0)))
            for k in loss_spread:
                loss_spread[k] = max(loss_spread[k], abs(float(n_losses[k]) - j_losses[k]))
            norms.append(_norm(n_grads.values()))

        tcfg = load_config(W.FLAGSHIP, W.OPTS)
        tm = MaskRCNN(dataclasses.replace(_port_config(tcfg), box_head_dropout=0.0))
        teacher = MaskRCNN(tm.config)
        tm.load_state_dict(student)
        teacher.load_state_dict(teacher_sd)
        teacher.eval().requires_grad_(False)
        steps = MTTrainer(tm, teacher, tcfg, torch.Generator())
        steps.iteration = iteration
        t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}  # noqa: E731
        losses = steps.mt_losses(t(lab), t(unl))
        total = sum(P.weight_sum_losses(losses, iteration, P.MTConfig.from_cfg(tcfg)).values())
        total.backward()
    named = [(n, x) for n, x in tm.named_parameters() if x.requires_grad]
    named += [(n, b) for n, b in tm.named_buffers() if b.requires_grad]
    return {"record": record, "iteration": iteration, "losses": {k: float(v.detach()) for k, v in losses.items()},
            "total": float(total.detach()), "j_losses": j_losses, "j_total": float(j_total), "loss_spread": loss_spread,
            "grads": {n: x.grad.clone() for n, x in named}, "j_grads": j_grads, "spread": spread,
            "j_noisy_norms": norms}


def _norm(arrays) -> float:
    return float(np.sqrt(sum(float((np.asarray(a, np.float64) ** 2).sum()) for a in arrays)))


def _port_config(cfg):
    from mmt_psm_tpu_torch.models import ModelConfig

    return ModelConfig.from_cfg(cfg, train=True)


def test_witness_state_losses_match_jax(run):
    """At the port's step-30 state each loss agrees with JAX's within 1e-4
    relative or JAX's own move under the noise (measured: the relation-NMS
    loss 1.2e-3 against JAX's 9.3e-3, PSM 4.8e-4 against 1.5e-3, every other
    within 3.2e-5): the port computes no larger losses there."""
    got, want, spread = run["losses"], run["j_losses"], run["loss_spread"]
    assert run["iteration"] == 1001 + WITNESS_STEPS
    assert sorted(got) == sorted(want) and set(MT_KEYS) <= set(got)
    print(f"witness step {WITNESS_STEPS} losses (port, JAX, relative difference, JAX's own relative move): "
          + "; ".join(f"{k} {got[k]} {w} {abs(got[k] - w) / abs(w):.3g} {spread[k] / abs(w):.3g}"
                      for k, w in want.items()))
    for k, w in want.items():
        assert abs(got[k] - w) <= max(LOSS_RTOL * abs(w), spread[k]), (k, got[k], w, spread[k])
    assert abs(got["loss_box_reg"] - want["loss_box_reg"]) <= 1e-6 * want["loss_box_reg"]


def test_witness_state_gradients_match_jax(run):
    """Every gradient of the step's weighted total within 1e-3 of its largest
    |JAX gradient| + 1e-6, or within JAX's own spread; the global norm (the
    clip's) within the range of JAX's noisy ones."""
    by_spread = []
    for name, got in run["grads"].items():
        want = U.port_grad_of(name, run["j_grads"])
        spread = run["spread"][flax_key(name)[0]]
        strict = 1e-3 * float(np.abs(want).max())
        U.assert_close(got, want, atol=max(strict, spread) + 1e-6, what=name)
        if float(np.abs(got.numpy() - want).max()) > strict + 1e-6:
            by_spread.append(name)
    assert len(run["grads"]) > 250
    norm = _norm(g.numpy() for g in run["grads"].values())
    assert min(run["j_noisy_norms"]) <= norm <= max(run["j_noisy_norms"]), (norm, run["j_noisy_norms"])
    print(f"witness step {WITNESS_STEPS}: global gradient norm {norm} (JAX {_norm(run['j_grads'].values())}, "
          f"noisy {run['j_noisy_norms']}); {len(by_spread)} of {len(run['grads'])} tensors held by JAX's spread")
