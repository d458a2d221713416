"""Each arm of the lift experiment takes the JAX package's step.

The lift's graph (the plain Mask R-CNN with the greedy post-processor and
the MGD hint adaptor, ``mt_lift_experiment.LIFT_MODEL``) at a 64 canvas in
float32, its counts cut to ``STEP_SMALL``; the port's seeded init with
randomised FrozenBN statistics on both sides (``torch_port_variants.pair_of``),
a teacher whose hint adaptor and box predictor differ from the student's;
the batch, the unlabeled batch and the sampler draws of
test_torch_port_mt_step.py (``torch_port_util.same_draws``). Each arm's
config is the tool's ``arm_config`` at its defaults with ``--sharpen
--hard-neg`` (the JAX gate's recipe), and the step runs at the ramp's
plateau, START_MT + RAMPUP_STEP, where the MT losses count in full:

* sup: LAMBDA 0, the supervised step (``Trainer.step``);
* mt: PSM (sharpened, hard negatives) + MGD at FG_HINT 0.05;
* odkd: single-view soft CE + the unmasked hint, FG_HINT 0;
* psm: FG_HINT 0, PSM alone; mgd: CLS_LOSS 0, MGD alone.

The port's arm runs its step object's own ``step`` with the update cut to
the backward, and returns the arm's losses (``ARM_MT_KEYS``). JAX's arm:
those losses weighted by JAX's ``weight_sum_losses`` under the arm's own
``MTConfig``; the values and
gradients come from one jitted function that computes the supervised
losses and JAX's unlabeled losses under the mt and the odkd configs (PSM
and MGD read no key in which mt, psm and mgd differ), each arm's gradient
as the pullback of its weighted total. Losses within 1e-4 relative; each
gradient within 1e-3 of its largest |JAX gradient| + 1e-6, or within
JAX's own spread (its gradient on the images with 1e-5 relative noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_lift as PL
import torch_port_util as U
import torch_port_variants as V
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu_torch.data.synthetic import generate_unlabeled_batch
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L
from mmt_psm_tpu_torch.train import mt_step as P
from mmt_psm_tpu_torch.utils.jax_params import flax_key, load_jax_params

U.setup_torch()

SIZE = 64
STEP_SMALL = dict(pre_nms_top_n_train=64, post_nms_top_n_train=64, fpn_post_nms_top_n_train=64,
                  box_batch_per_image=32, mask_max_pos=8, pre_nms_top_n_test=64, post_nms_top_n_test=64,
                  fpn_post_nms_top_n_test=64, detections_per_img=16)
ARGS = L.parse_args(["--sharpen", "--hard-neg", "--device", "cpu"])
PLATEAU = ARGS.start_mt + max(ARGS.iters // 6, 50)
ARMS = ("sup", "mt", "odkd", "psm", "mgd")
SUP = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_mask")
NOISE = 1e-5
# the odkd arm's losses in the JAX function's dict
ODKD = "odkd/"
# each arm's consistency losses, as JAX's unlabeled_losses computes them under
# the arm's MTConfig: PSM where CLS_LOSS > 0 (ODKD's soft CE in its place),
# MGD where FG_HINT > 0, ODKD's unmasked hint where the model has the adaptor
ARM_MT_KEYS = {"sup": (), "mt": ("mt_classifier", "mt_fg_loss"), "odkd": ("mt_classifier", "mt_hint_loss"),
               "psm": ("mt_classifier",), "mgd": ("mt_fg_loss",)}


def _jax_mt(arm):
    return J.MTConfig.from_cfg(PL.jax_arm_cfg(L.arm_config(ARGS, arm)))


@pytest.fixture(scope="module")
def run():
    cfgs = {arm: L.arm_config(ARGS, arm) for arm in ARMS}
    assert P.MTConfig.from_cfg(cfgs["mt"]).sharpen and P.MTConfig.from_cfg(cfgs["mt"]).hard_neg
    assert float(J.mt_loss_weight(jnp.asarray(PLATEAU), _jax_mt("mt"))) == ARGS.lam
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, _, tm, flat = V.pair_of(*PL.lift_configs(SIZE, with_hint=True, **STEP_SMALL))
        flat_t = dict(flat)
        rng = np.random.default_rng(7)
        for k in flat_t:
            if k.startswith(("hint_adaptor/", "box_predictor/")):
                flat_t[k] = (flat[k] + rng.normal(0.0, 0.02, flat[k].shape)).astype(np.float32)
        batch = U.train_batch(0, 2, SIZE)
        ub = generate_unlabeled_batch(5, 2, image_size=SIZE, max_instances=U.MAX_GT)
        gt, params, t_params = U.jax_gt(batch), U.unflatten(flat), U.unflatten(flat_t)
        sizes = jnp.asarray(batch["image_size"])
        key = jax.random.PRNGKey(1)

        def unl(s_images):
            return {"t_images": jnp.asarray(ub["t_images"]), "s_images": s_images,
                    "image_size": jnp.asarray(ub["image_size"])}

        def losses_fn(p, image, s_images):
            out = dict(jm.apply({"params": p}, image, sizes, gt, train=True, rngs={"sample": jax.random.PRNGKey(0)}))
            for prefix, arm in (("", "mt"), (ODKD, "odkd")):
                for k, v in J.unlabeled_losses(jm, p, t_params, unl(s_images), key, _jax_mt(arm)).items():
                    out[prefix + k] = v
            return out

        @jax.jit
        def grad_fn(p, image, s_images, w):
            def total(q):
                losses = losses_fn(q, image, s_images)
                return sum(w[k] * jnp.asarray(losses[k], jnp.float32) for k in w), losses

            return jax.value_and_grad(total, has_aux=True)(p)

        noise = np.random.default_rng(1)
        noisy = lambda x: (x * (1 + NOISE * noise.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
        as_np = lambda g: U.flatten(jax.tree_util.tree_map(np.asarray, g))  # noqa: E731
        all_keys = SUP + ("mt_classifier", "mt_fg_loss", ODKD + "mt_classifier", ODKD + "mt_hint_loss")
        jax_arms = {}
        for arm in ARMS:
            ones = {k: 1.0 for k in SUP + ARM_MT_KEYS[arm]}
            weights = {k: float(v) for k, v in J.weight_sum_losses(ones, jnp.asarray(PLATEAU), _jax_mt(arm)).items()}
            name = (lambda k: ODKD + k if k.startswith("mt") else k) if arm == "odkd" else (lambda k: k)
            w = {k: jnp.float32(0.0) for k in all_keys}
            w.update({name(k): jnp.float32(v) for k, v in weights.items()})
            (total, losses), grads = grad_fn(params, batch["image"], ub["s_images"], w)
            _, grads_noisy = grad_fn(params, noisy(batch["image"]), noisy(ub["s_images"]), w)
            grads, grads_noisy = as_np(grads), as_np(grads_noisy)
            # JAX's own spread of each tensor's gradient (a layout-free max)
            spread = {k: float(np.abs(grads_noisy[k] - g).max()) for k, g in grads.items()}
            del grads_noisy
            jax_arms[arm] = {"total": float(total), "grads": grads, "spread": spread,
                             "losses": {k: float(losses[name(k)]) for k in ones}}

        port_arms = {}
        for arm in ARMS:
            steps = L.arm_steps(tm, cfgs[arm])
            load_jax_params(steps.teacher, flat_t)
            steps.iteration = PLATEAU
            captured = {}

            def backward_only(total, _c=captured):
                _c["total"] = total.detach()
                total.backward()

            steps.update = backward_only
            out = steps.step({k: U.t(v) for k, v in batch.items()},
                             {k: U.t(v) for k, v in ub.items()} if arm != "sup" else None)
            # the gradients alone are kept: five step objects hold ~2 GB
            grads = {n: None if p.grad is None else p.grad.numpy().copy()
                     for n, p in steps.model.named_parameters() if p.requires_grad}
            port_arms[arm] = {"grads": grads, "out": out, "total": captured["total"]}
            del steps
    return {"jax": jax_arms, "port": port_arms}


@pytest.mark.parametrize("arm", ARMS)
def test_arm_step_matches_jax(run, arm):
    want, got = run["jax"][arm], run["port"][arm]
    out = got["out"]
    mt_keys = ARM_MT_KEYS[arm]
    assert sorted(out) == sorted(SUP + mt_keys + ("loss_total",) + (("mt_weight",) if mt_keys else ())), sorted(out)
    if mt_keys:
        assert float(out["mt_weight"]) == ARGS.lam
    for k in SUP + mt_keys:
        w = want["losses"][k]
        assert np.isfinite(w) and w > 0, (k, w)
        U.assert_close(out[k], w, atol=0.0, rtol=1e-4, what=f"{arm} {k}")
    U.assert_close(got["total"], want["total"], atol=0.0, rtol=1e-4, what=f"{arm} weighted total")

    by_spread, reached = [], set()
    for name, grad in got["grads"].items():
        g_want = U.port_grad_of(name, want["grads"])
        if grad is None:
            assert not np.any(g_want), (arm, name)
            continue
        spread = want["spread"][flax_key(name)[0]]
        strict = 1e-3 * float(np.abs(g_want).max())
        U.assert_close(grad, g_want, atol=max(strict, spread) + 1e-6, what=f"{arm} gradient of {name}")
        if float(np.abs(grad - g_want).max()) > strict + 1e-6:
            by_spread.append(name)
        if np.any(g_want):
            reached.add(name.split(".")[0])
    assert len(by_spread) <= 4, by_spread
    # the hint adaptor learns where MGD or ODKD's hint reaches it, and only there
    assert ("hint_adaptor" in reached) == (arm in ("mt", "odkd", "mgd")), (arm, sorted(reached))
