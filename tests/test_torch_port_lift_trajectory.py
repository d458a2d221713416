"""Five consecutive mean-teacher steps of the lift's mt and mgd arms against
the JAX package's.

The step test (test_torch_port_lift_steps.py) holds one step's losses and
gradients, and test_torch_port_lift_update.py one update; this holds what
a step hands to the next: the student, the momentum, the teacher's EMA, the
iteration and the optimizer's count, the teacher's eval mode and the step
generator. The lift's graph with the MGD hint adaptor at a 64 canvas in
float32, the counts cut to ``torch_port_lift.STEP_SMALL``, the port's seeded
init with randomised FrozenBN statistics on both sides
(``torch_port_variants.pair_of``), a teacher whose hint adaptor and box
predictor differ from the student's, the sampler draws of
test_torch_port_mt_step.py (``torch_port_util.same_draws``), and the same
mask targets: the port's step takes the JAX package's jitted
``crop_masks_to_boxes`` of the RoIs it selected. A target pixel is a
threshold at 0.5 of a bilinear sample, and where a gt box has integer
corners some samples are exactly 0.5 in exact arithmetic; float32 rounding
of the sample coordinates then decides them (XLA's jit rewrites the
coordinate formula with a reciprocal for the division, as
test_torch_port_roi_align.py records; the port divides), so the two
packages differ there, and only there
(``test_mask_targets_equal_jax_but_at_exact_ties``): at the labeled batch
of seed 3, 9 of 12,544 target pixels, which moved ``loss_mask`` by 4.9e-4
of itself at the first step and the mask head's weights after five steps
by 6 to 23 times JAX's spread. The lift's box head has no dropout
(ROI_BOX_HEAD.DO 0), so no dropout draw is to be made equal.

Each arm's config is the tool's ``arm_config`` with ``--sharpen
--hard-neg``. Both sides start two iterations before the schedule's step
(1348: the learning rate drops at 1350, inside the five steps; MT at full
weight) with the optimizer's count there and no momentum, and take five
steps on five labeled and five unlabeled batches: the port's step object
of the tool (``arm_steps``) its own ``step``, JAX its jitted
``make_mt_step`` under the arm's config and optimizer.

The bound is JAX's own spread: the largest difference between any two of
its runs, on the batches and on two copies with 1e-5 relative noise in the
images, doubled (three runs underestimate the range of chaotic steps: by
the fifth step JAX's losses move by up to 11% between runs). Each step's
losses within the larger of 1e-4 relative and that; after the fifth step
every tensor of the student and of the teacher within the larger of that
and 1e-3 of JAX's largest move of the tensor over the five steps, plus four
float32 ulps of its largest value.
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
import torch_port_variants as V
from mmt_psm_tpu.models import mask_head as JMH
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu.train.optim import make_optimizer as jax_make_optimizer
from mmt_psm_tpu.train.supervised import create_train_state
from chip_smoke import exact_crop
from mmt_psm_tpu_torch.data.synthetic import generate_batch, generate_unlabeled_batch
from mmt_psm_tpu_torch.models import detector as PD
from mmt_psm_tpu_torch.models.mask_head import crop_masks_to_boxes
from mmt_psm_tpu_torch.tools import mt_lift_experiment as L
from mmt_psm_tpu_torch.utils.jax_params import flax_key, load_jax_params

U.setup_torch()

SIZE = 64
STEPS = 5
ARGS = L.parse_args(["--sharpen", "--hard-neg", "--device", "cpu"])
# the schedule's step (1350) falls inside the five steps; MT at full weight
START = int(ARGS.iters * 0.75) - 2
ARMS = ("mt", "mgd")
# JAX's own spread: the largest difference between any two of its runs, on
# the batches and on NOISE_DRAWS copies with NOISE relative noise in the images
NOISE, NOISE_DRAWS = 1e-5, 2
# three JAX runs underestimate the range of its chaotic steps (by the fifth
# step its losses move by up to 11% between runs): the bound is twice the
# largest difference between two of them
SPREAD_FACTOR = 2.0
LOSSES = {"mt": ("mt_classifier", "mt_fg_loss"), "mgd": ("mt_fg_loss",)}
SUP = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_mask")


_JAX_CROP = jax.jit(jax.vmap(lambda m, i, bx: JMH.crop_masks_to_boxes(m[i], bx, 28)))


def _jax_targets(gt_masks, gt_idx, boxes, resolution: int):
    """The port's ``crop_masks_to_boxes`` computed by the JAX package (as
    its ``forward_train`` gathers and crops, jitted)."""
    assert resolution == 28
    out = _JAX_CROP(jnp.asarray(gt_masks.numpy()), jnp.asarray(gt_idx.numpy()), jnp.asarray(boxes.detach().numpy()))
    return torch.from_numpy(np.array(out))


def _batches():
    labeled = [U.train_batch(s, 2, SIZE) for s in range(STEPS)]
    unlabeled = [generate_unlabeled_batch(5 + s, 2, image_size=SIZE, max_instances=U.MAX_GT) for s in range(STEPS)]
    return labeled, unlabeled


def _jax_run(jm, params, t_params, jcfg, batches):
    """JAX's five steps from START: the losses of each step and the final
    student and teacher as flat numpy maps."""
    jmt = J.MTConfig.from_cfg(jcfg)
    tx, _ = jax_make_optimizer(jcfg, params)
    state = create_train_state(params, tx, with_teacher=True)
    state = state.replace(step=jnp.asarray(START, jnp.int32), teacher_params=t_params,
                          opt_state=optax.tree_utils.tree_set(state.opt_state, count=jnp.asarray(START, jnp.int32)))
    step = jax.jit(J.make_mt_step(jm, tx, jmt))

    def run(noise):
        s, losses = state, []
        for lb, ub in zip(*batches):
            lb = {k: jnp.asarray(noise(v) if k == "image" else v) for k, v in lb.items()}
            ub = {k: jnp.asarray(noise(v) if k.endswith("images") else v) for k, v in ub.items()}
            s, metrics = step(s, lb, ub, jax.random.PRNGKey(0))
            losses.append({k: float(v) for k, v in metrics.items()})
        as_np = lambda tree: U.flatten(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
        assert int(s.step) == START + STEPS
        return {"losses": losses, "student": as_np(s.params), "teacher": as_np(s.teacher_params)}

    rng = np.random.default_rng(1)
    noisy = lambda x: (x * (1 + NOISE * rng.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
    return run(lambda x: x), [run(noisy) for _ in range(NOISE_DRAWS)]


@pytest.fixture(scope="module")
def runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        mp.setattr(PD, "crop_masks_to_boxes", _jax_targets)
        jm, _, tm, flat = V.pair_of(*PL.lift_configs(SIZE, with_hint=True, **PL.STEP_SMALL))
        flat_t = dict(flat)
        rng = np.random.default_rng(7)
        for k in flat_t:
            if k.startswith(("hint_adaptor/", "box_predictor/")):
                flat_t[k] = (flat[k] + rng.normal(0.0, 0.02, flat[k].shape)).astype(np.float32)
        batches = _batches()
        for arm in ARMS:
            cfg = L.arm_config(ARGS, arm)
            clean, noisy = _jax_run(jm, U.unflatten(flat), U.unflatten(flat_t), PL.jax_arm_cfg(cfg), batches)
            steps = L.arm_steps(tm, cfg)
            load_jax_params(steps.teacher, flat_t)
            steps.iteration = START
            with warnings.catch_warnings():  # the count advanced without optimizer steps
                warnings.simplefilter("ignore")
                for _ in range(START):
                    steps.scheduler.step()
            port_losses = []
            for lb, ub in zip(*batches):
                out_k = steps.step({k: U.t(v) for k, v in lb.items()}, {k: U.t(v) for k, v in ub.items()})
                port_losses.append({k: float(v) for k, v in out_k.items()})
            assert steps.iteration == START + STEPS and steps.scheduler.last_epoch == START + STEPS
            assert not steps.teacher.training and steps.model.training
            out[arm] = {"jax": clean, "jax_noisy": noisy, "losses": port_losses, "flat": flat, "flat_t": flat_t,
                        "student": {k: v.detach().numpy().copy() for k, v in steps.model.state_dict().items()},
                        "teacher": {k: v.detach().numpy().copy() for k, v in steps.teacher.state_dict().items()}}
            del steps
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_each_steps_losses_match_jax(runs, arm):
    r = runs[arm]
    jax_runs = [r["jax"]] + r["jax_noisy"]
    for i, (got, want) in enumerate(zip(r["losses"], r["jax"]["losses"])):
        assert float(got["mt_weight"]) == want["mt_weight"] == ARGS.lam, i
        for k in SUP + LOSSES[arm] + ("loss_total",):
            w = want[k]
            assert np.isfinite(w) and w > 0, (i, k, w)
            bound = max(1e-4 * abs(w), SPREAD_FACTOR * _spread([run["losses"][i][k] for run in jax_runs]))
            assert abs(got[k] - w) <= bound, f"step {i} {k}: port {got[k]!r}, JAX {w!r}, bound {bound:.3g}"


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("which", ("student", "teacher"))
def test_student_and_teacher_after_five_steps_match_jax(runs, arm, which):
    r = runs[arm]
    start = r["flat"] if which == "student" else r["flat_t"]
    moved = 0
    for name, got in r[which].items():
        key = flax_key(name)[0]
        want = U.port_grad_of(name, r["jax"][which])
        spread = SPREAD_FACTOR * _spread([run[which][key] for run in [r["jax"]] + r["jax_noisy"]])
        move = float(np.abs(r["jax"][which][key] - start[key]).max())
        strict = 1e-3 * move
        ulps = 4 * float(np.spacing(np.float32(np.abs(want).max())))
        err = float(np.abs(got - want).max())
        assert err <= max(strict, spread) + ulps, f"{which} {name}: err {err:.3g}, move {move:.3g}, spread {spread:.3g}"
        moved += move > 0
    assert moved > 80, moved


def _spread(values):
    """The largest difference between any two of JAX's runs."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for i, a in enumerate(values) for b in values[i + 1:])


def test_mask_targets_equal_jax_but_at_exact_ties():
    """The port's mask targets against the JAX package's jitted ones, on
    the gt boxes of four lift-sized batches (256 px, two images, up to 64
    cells), whose integer corners make exact ties, and on the same boxes
    moved by a fraction of a pixel: every target pixel equal but those
    whose exact sample is 0.5 (within 1e-9), which float32 rounding
    decides. The first run counted 40 such pixels of 70,560 (90 RoIs) and 3
    of them different; none of the moved boxes' pixels differs."""
    ties = differ = pixels = 0
    rng = np.random.default_rng(3)
    for seed in range(4):
        b = generate_batch(seed, 2, image_size=256, max_instances=64)
        masks, valid = b["masks"], b["gt_valid"].astype(bool)
        idx = np.broadcast_to(np.arange(masks.shape[1]), valid.shape).astype(np.int64)
        for boxes in (b["boxes"], b["boxes"] + rng.uniform(-0.5, 0.5, b["boxes"].shape)):
            boxes = boxes.astype(np.float32)
            got = crop_masks_to_boxes(torch.from_numpy(masks), torch.from_numpy(idx), torch.from_numpy(boxes), 28)
            want = np.asarray(_JAX_CROP(jnp.asarray(masks), jnp.asarray(idx), jnp.asarray(boxes)))
            exact = exact_crop(*map(torch.from_numpy, (masks, np.ascontiguousarray(idx), boxes)), 28).numpy()
            tie = np.abs(exact - 0.5) < 1e-9
            diff = (got.numpy() != want) & valid[:, :, None, None]
            assert not np.any(diff & ~tie), np.argwhere(diff & ~tie)[:5]
            ties += int((tie & valid[:, :, None, None]).sum())
            differ += int(diff.sum())
            pixels += int(valid.sum()) * 28 * 28
    print(f"target pixels: {pixels}, exact ties: {ties}, different: {differ}")
    assert differ <= ties and 0 < ties < pixels // 1000, (differ, ties, pixels)
