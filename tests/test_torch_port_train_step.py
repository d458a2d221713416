"""The port's supervised train step against the JAX package's.

Flagship graph (relation-NMS with REG_IOU, CIAM with deep supervision)
at a 128 canvas in float32 on the CPU, the train counts cut to
``torch_port_util.TRAIN_SMALL`` (no dropout), the same weights and the
same sampler draws on both sides (``torch_port_util.same_draws``):

* ``MaskRCNN.forward_train``'s six losses within 1e-4 relative;
* every gradient within 1e-3 of its largest |JAX gradient| + 1e-6, or
  within what JAX's own gradient moves when the image carries float32
  noise of the port's size (1e-5 relative), where that is larger: the
  trainable parameters, and the FrozenBN tensors of the trainable stages,
  which the JAX model holds as parameters and whose gradients count in its
  clip norm. The second bound is for the box regression's gradient through
  the relation head's geometric embedding, sin(100 log|dx/w|): for two
  near-concentric boxes a 1e-5 px shift of a centre turns its phase by
  1e-2, so neither package's float32 gradient is stabler than that;
* one ``Trainer.step`` against ``make_optimizer``'s optax chain on the JAX
  gradients, with CLIP_GRAD_NORM engaged and not: each parameter's delta
  within 2e-5 of its largest |delta| + four ulps of the weight (the delta
  is read as new - old in float32), frozen tensors bit-unchanged. Both
  steps start from the same gradients, so only float32 rounding separates
  them; leaving the FrozenBN gradients out of the clip norm moves the
  clipped deltas by more than that, which this catches.

The float32 backbone noise (~2e-6 of the feature range) passes through
the discrete choices (top-k, matching, sampling, the relation sort)
identically at this seed; the tolerances cover sums taken in another
order by XLA and by PyTorch's CPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.train.optim import make_optimizer as jax_make_optimizer
from mmt_psm_tpu_torch.models.layers import FrozenBatchNorm2d
from mmt_psm_tpu_torch.train import Trainer
from mmt_psm_tpu_torch.train.optim import clip_tensors
from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

U.setup_torch()

# the relation head's geometric gate log(max(relu(WG(pos)), 1e-6)) has a
# pole at 0: a gate that lands within float32 noise of it gives the two
# packages different attention. The test's WG bias keeps every gate near 5.
WG_BIAS = 5.0
NOISE = 1e-5
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "nms_loss", "loss_mask")


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, _, tm, flat = U.build_pair(**U.TRAIN_SMALL)
        flat["relation_nms/relation_module/WG.bias"] = np.full_like(flat["relation_nms/relation_module/WG.bias"], WG_BIAS)
        params = {"params": U.unflatten(flat)}
        load_jax_params(tm, flat)
        batch = U.train_batch()
        gt = U.jax_gt(batch)

        def loss_fn(p, image):
            losses = jm.apply({"params": p}, image, jnp.asarray(batch["image_size"]), gt,
                              train=True, rngs={"sample": jax.random.PRNGKey(0)})
            return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), losses

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, j_losses), j_grads = grad_fn(params["params"], batch["image"])
        # JAX's own gradient on the image perturbed by float32 noise: how far
        # an ill-conditioned gradient moves without any port in the way
        noisy = batch["image"] * (1 + NOISE * np.random.default_rng(1).standard_normal(batch["image"].shape))
        j_grads_noisy = grad_fn(params["params"], noisy.astype(np.float32))[1]

        tm.train()
        tensors = clip_tensors(tm)
        losses = tm.forward_train(U.t(batch["image"]), U.t(batch["image_size"]), U.torch_gt(batch),
                                  torch.Generator())
        sum(losses.values()).backward()
    return {"jm": jm, "tm": tm, "flat": flat, "batch": batch, "j_losses": j_losses, "losses": losses,
            "j_grads": U.flatten(jax.tree_util.tree_map(np.asarray, j_grads)), "tensors": tensors,
            "j_grads_noisy": U.flatten(jax.tree_util.tree_map(np.asarray, j_grads_noisy))}


def test_losses_match_jax(run):
    got, want = run["losses"], run["j_losses"]
    assert sorted(got) == sorted(want) == sorted(LOSSES)
    for k in LOSSES:
        w = float(want[k])
        assert np.isfinite(w) and w > 0, (k, w)
        U.assert_close(got[k].detach(), w, atol=0.0, rtol=1e-4, what=k)


def _named_grad_tensors(tm):
    """(name, tensor) of every tensor that gets a gradient: the trainable
    parameters and the FrozenBN buffers ``clip_tensors`` switched on."""
    out = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    out += [(n, b) for n, b in tm.named_buffers() if b.requires_grad]
    return out


def test_every_gradient_matches_jax(run):
    tm = run["tm"]
    named = _named_grad_tensors(tm)
    assert {id(t) for _, t in named} == {id(t) for t in run["tensors"]}
    bn = [n for n, _ in named if n.rsplit(".", 1)[1] in ("running_mean", "running_var")]
    assert any(n.startswith("backbone.body.layer2.") for n in bn)
    assert not any(n.startswith(("backbone.body.stem.", "backbone.body.layer1.")) for n, _ in named)
    by_spread = []
    for name, tensor in named:
        want = U.port_grad_of(name, run["j_grads"])
        spread = float(np.abs(U.port_grad_of(name, run["j_grads_noisy"]) - want).max())
        strict = 1e-3 * float(np.abs(want).max())
        assert tensor.grad is not None, name
        U.assert_close(tensor.grad, want, atol=max(strict, spread) + 1e-6, what=name)
        if float(np.abs(tensor.grad.numpy() - want).max()) > strict + 1e-6:
            by_spread.append(name)
    # only the box regression's gradient through the geometric embedding is
    # conditioned worse than the strict bound (measured: bbox_pred only)
    assert len(by_spread) <= 4, by_spread
    # every tensor JAX trains that the port freezes got no gradient in JAX either
    for key, g in run["j_grads"].items():
        if key.startswith(("backbone/body/stem/", "backbone/body/layer1_")):
            assert not np.any(g), key
    assert len(named) > 250


def _jax_step(run, clip: float):
    """One optax update of the flagship SOLVER chain on the JAX gradients."""
    from mmt_psm_tpu.config import get_cfg as jax_get_cfg

    cfg = jax_get_cfg()
    cfg.merge_from_file(U.FLAGSHIP)
    cfg.merge_from_list(["SOLVER.CLIP_GRAD_NORM", clip])
    params = U.unflatten(run["flat"])
    grads = U.unflatten(run["j_grads"])
    tx, _ = jax_make_optimizer(cfg, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    norm = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in jax.tree_util.tree_leaves(grads))))
    return U.flatten(jax.tree_util.tree_map(np.asarray, updates)), norm


@pytest.mark.parametrize("engaged", [False, True])
def test_one_step_delta_matches_optax(run, engaged, monkeypatch):
    """The flagship's CLIP_GRAD_NORM (10) against the measured norm: a clip
    above the norm leaves the gradients alone; a clip at half the norm scales
    them by ~0.5, with the FrozenBN gradients counted in the norm as optax
    counts them."""
    norm = _jax_step(run, 0.0)[1]
    clip = norm / 2 if engaged else 10 * norm
    updates, _ = _jax_step(run, clip)

    from mmt_psm_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(U.FLAGSHIP)
    cfg.merge_from_list(["SOLVER.CLIP_GRAD_NORM", clip])
    tm = U.MaskRCNN(run["tm"].config)
    load_jax_params(tm, run["flat"])
    trainer = Trainer(tm, cfg, torch.Generator())
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    monkeypatch.setattr(tm, "forward_train", lambda *a: _replay(tm, run))
    trainer.step({k: U.t(v) for k, v in run["batch"].items()})
    after = tm.state_dict()

    frozen_bn = {n for n, m in tm.named_modules() if isinstance(m, FrozenBatchNorm2d)}
    moved = 0
    for name, value in after.items():
        delta = (value - before[name]).numpy()
        frozen = name.rsplit(".", 1)[0] in frozen_bn or name.startswith(("backbone.body.stem.",
                                                                          "backbone.body.layer1."))
        if frozen:
            assert not np.any(delta), name
            continue
        want = U.port_grad_of(name, updates)
        # the delta is read back as new - old in float32: one ulp of the weight
        ulp = float(np.spacing(np.abs(before[name].numpy()).max()))
        U.assert_close(delta, want, atol=2e-5 * float(np.abs(want).max()) + 4 * ulp, what=name)
        moved += 1
    assert moved > 100
    # bias lr x BIAS_LR_FACTOR (2): a bias moves by twice the lr times its momentum buffer
    groups = trainer.optimizer.param_groups
    assert groups[1]["lr"] == pytest.approx(2 * groups[0]["lr"])


def _replay(tm, run):
    """Losses whose gradients are the JAX gradients: sum <grad_jax, p> over
    the tensors the port differentiates, so the step sees exactly them."""
    total = 0.0
    for name, tensor in _named_grad_tensors(tm):
        total = total + (U.t(U.port_grad_of(name, run["j_grads"])) * tensor).sum()
    return {"loss_total_replay": total}


@pytest.mark.parametrize("p", [0.5, 0.25])
def test_train_mode_dropout(p):
    """flax ``Dropout``: zeros at rate p, kept values scaled by exactly
    1/(1-p), the mask drawn from the step's generator; the box head's
    extractor is the identity of eval mode without it."""
    from mmt_psm_tpu_torch.models.box_head import FPN2MLPExtractor, dropout

    x = torch.rand(256, 1024, generator=torch.Generator().manual_seed(0)) + 0.5
    y = dropout(x, p, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float((~kept).float().mean()) - p) < 0.01  # 262144 draws: sd < 0.001
    assert torch.equal(y[kept], x[kept] / (1.0 - p))
    assert torch.equal(y, dropout(x, p, torch.Generator().manual_seed(1)))

    ex = FPN2MLPExtractor(16, 2, 64, dropout=p)
    ex.init_weights(torch.Generator().manual_seed(0))
    pooled = torch.rand(8, 2, 2, 16, generator=torch.Generator().manual_seed(1))
    ex.eval()
    plain = ex(pooled)
    assert torch.equal(plain, ex(pooled, torch.Generator().manual_seed(2)))
    ex.train()
    a = ex(pooled, torch.Generator().manual_seed(2))
    assert torch.equal(a, ex(pooled, torch.Generator().manual_seed(2)))
    assert not torch.equal(a, plain)
    assert float((a == 0).float().mean()) > float((plain == 0).float().mean())
    with pytest.raises(ValueError):
        ex(pooled)


def test_build_trainer_step_on_the_cpu(monkeypatch):
    """The entry point: on the card unless the caller asks for the CPU; one
    step with the flagship's dropout, sampler and clipping moves every
    trainable tensor that gets a gradient and leaves the frozen ones
    bit-unchanged. The losses come back detached, with their sum."""
    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.train import build_trainer

    small = ["TPU.IMAGE_SIZE", 128, "TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
             "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 64, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(opts=small)
    trainer = build_trainer(device="cpu", opts=small)
    assert trainer.model.training and trainer.model.config.box_head_dropout == 0.5
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    losses = trainer.step(batch_to_torch(generate_batch(3, 2, image_size=128, max_instances=U.MAX_GT), "cpu"))
    assert sorted(losses) == sorted(LOSSES + ("loss_total",))
    assert all(torch.isfinite(v) and not v.requires_grad for v in losses.values())
    torch.testing.assert_close(losses["loss_total"], sum(losses[k] for k in LOSSES))
    frozen_bn = {n for n, m in trainer.model.named_modules() if isinstance(m, FrozenBatchNorm2d)}
    after = trainer.model.state_dict()
    for name, p in trainer.model.named_parameters():
        if p.requires_grad and not name.endswith(".bias"):
            assert not torch.equal(after[name], before[name]), name  # weight decay moves every weight
    for name in after:
        if name.rsplit(".", 1)[0] in frozen_bn or name.startswith(("backbone.body.stem.", "backbone.body.layer1.")):
            assert torch.equal(after[name], before[name]), name
