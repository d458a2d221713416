"""Data-parallel train steps on the CPU: two gloo ranks against one process,
and against the JAX package.

The flagship graph at a 128 canvas in float32; a global batch of 2 images
(``generate_batch(0, ...)``, 6 and 8 gt), one on each rank. One spawn of two
ranks (``torch_port_dist.steps_rank``) runs, at W = 2, and holds against the
same step at W = 1 on the global batch (each rank computes its share of the
references in its own process, with the world size read as 1):

* ``pair_sup``/``pair_mt``: the supervised step at iteration START_MT and
  the MT step at the ramp's plateau (START_MT + RAMPUP_STEP), on the
  weights ``torch_port_util.build_pair`` exports from a JAX init (the
  train counts of TRAIN_SMALL, no dropout, a teacher whose hint adaptor
  differs), with ``same_draws``'s table of the global batch read by both
  ranks. The JAX package's single-process losses and gradients on the same
  weights and draws are computed here while the ranks run;
* ``gen_sup``/``gen_mt``: the same steps of ``build_mt_trainer`` from seed 0
  under ``torch_port_util.TRAIN_OPTS``, box-head dropout 0.5, every draw from
  the step's generator (the global table, each rank keeping its rows: the
  student's dropout masks by view);
* ``local_*``: the MT losses of ``gen_mt``'s state with one coupling made
  rank-local (a per-rank mean, a per-rank k-th, per-rank PSM ranks,
  per-rank draws), which must miss the W = 1 losses by more than the
  tolerance: the batch can show each fault.

Tolerances: the losses 2e-5 relative and the updated student and EMA
teacher ``rtol=1e-4, atol=1e-7``, as tests/test_multihost_train.py holds
JAX's mesh (``gen_*`` on every tensor; ``pair_*``, whose oneDNN
convolutions round by the batch size, on fc6 and every tensor to 1e-4 of
its norm); the ranks bit-identical; against JAX, the losses 1e-4
relative, every gradient within 1e-3 of its largest |JAX gradient| + 1e-6
or JAX's own spread under 1e-5 relative input noise, as
tests/test_torch_port_train_step.py and test_torch_port_mt_step.py hold one
process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist as D
import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.train import mt_step as J
from mmt_psm_tpu_torch.data.synthetic import generate_batch, generate_unlabeled_batch
from mmt_psm_tpu_torch.utils.jax_params import flax_key, load_jax_params

U.setup_torch()

START_MT, GRAD_STEP = 1000, 1250
# JAX's own gradient spread: the largest move of its gradient over
# NOISE_DRAWS copies of the inputs with NOISE relative noise
# (torch_port_variants.py)
NOISE, NOISE_DRAWS = 1e-5, 5
MT_KEYS = ("mt_classifier", "mt_fg_loss")
STEP_JOBS = ("pair_sup", "pair_mt", "gen_sup", "gen_mt")
LOCAL = ("mean", "kth", "psm", "draws")


def _opts(batch: int):
    opts = list(U.TRAIN_OPTS)
    opts[opts.index("SOLVER.IMS_PER_BATCH") + 1] = str(batch)
    return opts


def _jobs(pair_path):
    labeled = generate_batch(0, 2, image_size=128, max_instances=U.MAX_GT)
    unlabeled = generate_unlabeled_batch(5, 2, image_size=128, max_instances=U.MAX_GT)
    pair = {"build": {"state": pair_path}, "draws": "table", "labeled": labeled, "grads": True, "onednn": True}
    gen = {"build": {"opts": _opts(2)}, "labeled": labeled}
    # in pairs, rank 0 checking one job and rank 1 the other
    jobs = {
        "pair_sup": dict(pair, iteration=START_MT),
        "gen_sup": dict(gen, iteration=START_MT),
        "pair_mt": dict(pair, unlabeled=unlabeled, iteration=GRAD_STEP),
        "gen_mt": dict(gen, unlabeled=unlabeled, iteration=GRAD_STEP),
    }
    for kind in LOCAL:
        jobs[f"local_{kind}"] = dict(gen, unlabeled=unlabeled, iteration=GRAD_STEP, update=False, local=kind,
                                     against="gen_mt")
    checks = {"pair_sup": 0, "pair_mt": 0, "gen_sup": 1, "gen_mt": 1}
    return jobs, checks


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(U.FLAGSHIP)
    jmt = J.MTConfig.from_cfg(jcfg)
    assert (START_MT, GRAD_STEP) == (jmt.start_mt, jmt.start_mt + jmt.rampup_step)
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=2)
        jm, _, tm, flat = U.build_pair(**U.TRAIN_SMALL, with_hint_adaptor=True)
        flat["relation_nms/relation_module/WG.bias"] = np.full_like(flat["relation_nms/relation_module/WG.bias"],
                                                                   D.WG_BIAS)
        flat_t = dict(flat)
        rng = np.random.default_rng(7)
        for k in flat_t:
            if k.startswith("hint_adaptor/"):
                flat_t[k] = (flat[k] + rng.normal(0.0, 0.02, flat[k].shape)).astype(np.float32)
        load_jax_params(tm, flat)
        teacher = U.MaskRCNN(tm.config)
        load_jax_params(teacher, flat_t)
        pair_path = str(tmp / "pair.pt")
        torch.save({"config": tm.config, "student": tm.state_dict(), "teacher": teacher.state_dict()}, pair_path)
        jobs, checks = _jobs(pair_path)
        world = D.World(D.steps_rank, 2, tmp / "world", args=(jobs, checks, ("pair_sup", "pair_mt")), timeout=900)
        try:
            batch = U.train_batch()
            assert batch["gt_valid"].sum(1).tolist() == [6, 8]  # the ranks' counts differ
            ub = generate_unlabeled_batch(5, 2, image_size=128, max_instances=U.MAX_GT)
            gt = U.jax_gt(batch)
            t_params = U.unflatten(flat_t)

            def loss_fn(p, image, s_images):
                sup = jm.apply({"params": p}, image, jnp.asarray(batch["image_size"]), gt, train=True,
                               rngs={"sample": jax.random.PRNGKey(0)})
                unl = {"t_images": jnp.asarray(ub["t_images"]), "s_images": s_images,
                       "image_size": jnp.asarray(ub["image_size"])}
                mt = J.unlabeled_losses(jm, p, t_params, unl, jax.random.PRNGKey(1), jmt)
                weighted = J.weight_sum_losses({**sup, **mt}, jnp.asarray(GRAD_STEP, jnp.int32), jmt)
                return ((sum(v for k, v in weighted.items() if k not in MT_KEYS),
                         sum(weighted[k] for k in MT_KEYS)), {**sup, **mt})

            @jax.jit
            def grad_fn(p, image, s_images):
                """The losses and the gradients of the supervised losses (the
                supervised step's) and of the weighted total (the MT step's)."""
                (sup, mt), pull, losses = jax.vjp(lambda q: loss_fn(q, image, s_images), p, has_aux=True)
                one, zero = jnp.ones_like(mt), jnp.zeros_like(mt)
                return losses, pull((one, zero))[0], pull((one, one))[0]

            as_np = lambda g: U.flatten(jax.tree_util.tree_map(np.asarray, g))  # noqa: E731
            params = U.unflatten(flat)
            j_losses, j_sup, j_total = grad_fn(params, batch["image"], ub["s_images"])
            j_sup, j_total = as_np(j_sup), as_np(j_total)
            spread = {"pair_sup": {k: 0.0 for k in j_sup}, "pair_mt": {k: 0.0 for k in j_total}}
            noise = np.random.default_rng(1)
            noisy = lambda x: (x * (1 + NOISE * noise.standard_normal(x.shape))).astype(np.float32)  # noqa: E731
            for _ in range(NOISE_DRAWS):
                _, n_sup, n_total = grad_fn(params, noisy(batch["image"]), noisy(ub["s_images"]))
                for job, want, got in (("pair_sup", j_sup, as_np(n_sup)), ("pair_mt", j_total, as_np(n_total))):
                    for k in want:
                        spread[job][k] = max(spread[job][k], float(np.abs(got[k] - want[k]).max(initial=0.0)))
        except BaseException:
            world.kill()
            raise
    ranks = world.wait()
    return {"ranks": ranks, "j_losses": {k: float(v) for k, v in j_losses.items()},
            "j_grads": {"pair_sup": (j_sup, spread["pair_sup"]), "pair_mt": (j_total, spread["pair_mt"])}}


@pytest.mark.parametrize("job", STEP_JOBS)
def test_two_ranks_equal_one_process(run, job):
    """Losses within 2e-5 relative of the W = 1 step on the global batch.
    The updated student and teacher: with PyTorch's own convolution
    (``gen_*``) every tensor within rtol 1e-4, atol 1e-7; with oneDNN's,
    whose rounding moves with the batch size (``pair_*``), fc6 so, as
    tests/test_multihost_train.py holds it, and every tensor within 1e-4 of
    its norm."""
    checked = [r[job] for r in run["ranks"] if "ref_losses" in r[job]]
    assert len(checked) == 1
    res = checked[0]
    assert set(res["losses"]) == set(res["ref_losses"])
    rel = D.loss_rel(res["losses"], res["ref_losses"])
    assert max(rel.values()) <= D.LOSS_RTOL, rel
    for key in ("params", "teacher"):
        if job.startswith("gen_"):
            assert res[f"{key}_excess"][0] <= 0, res[f"{key}_excess"]
        assert res[f"{key}_fc6_excess"][0] <= 0, res[f"{key}_fc6_excess"]
        assert res[f"{key}_norm_excess"][0] <= 0, res[f"{key}_norm_excess"]
    assert all(np.isfinite(v) for v in res["losses"].values())
    if job.endswith("_mt"):
        assert res["losses"]["mt_weight"] == 5.0 and set(MT_KEYS) <= set(res["losses"])


@pytest.mark.parametrize("job", STEP_JOBS)
def test_ranks_bit_identical(run, job):
    """After the step every rank holds the same student and teacher, bit for
    bit, and reports the same global losses."""
    a, b = (r[job] for r in run["ranks"])
    assert a["identical"] and b["identical"]
    assert a["losses"] == b["losses"]


@pytest.mark.parametrize("job", ["pair_sup", "pair_mt"])
def test_losses_match_jax(run, job):
    """The global losses of the two ranks against the JAX package's single
    process on the same weights and draws, within 1e-4 relative as
    tests/test_torch_port_train_step.py and test_torch_port_mt_step.py hold
    one process's."""
    got, want = run["ranks"][0][job]["losses"], run["j_losses"]
    keys = [k for k in want if k not in MT_KEYS] if job == "pair_sup" else list(want)
    assert len(keys) == (6 if job == "pair_sup" else 8)
    rtol = 1e-4
    for k in keys:
        assert want[k] > 0
        assert abs(got[k] - want[k]) <= rtol * abs(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("job", ["pair_sup", "pair_mt"])
def test_summed_gradients_match_jax(run, job):
    """The gradient the clip sees on the ranks (their gradients summed)
    against JAX's gradient of the step's loss, tensor by tensor: within 1e-3
    of its largest |JAX gradient| plus JAX's own spread, + 1e-6. One process
    is held to the larger of the two, and at most 4 tensors past the first
    (tests/test_torch_port_mt_step.py); here both float32 effects meet, since
    oneDNN rounds a rank's batch of 1 otherwise than JAX's batch of 2, which
    flips a ReLU kink JAX's own noise flips (``layer3.5.conv2``: 0.0334 from
    JAX, 0.03338 from the one-process step, against JAX's own 0.03337), and
    the flip moves the gradient of every tensor below it: 54 tensors of the
    supervised step and 25 of the MT step need the spread."""
    grads = run["ranks"][0][job]["grads"]
    want_all, spreads = run["j_grads"][job]
    assert sum(n.startswith("hint_adaptor.") for n in grads) == 10 and len(grads) > 250
    for name, got in grads.items():
        want = U.port_grad_of(name, want_all)
        spread = spreads[flax_key(name)[0]]
        strict = 1e-3 * float(np.abs(want).max())
        U.assert_close(got, want, atol=strict + spread + 1e-6, what=name)


@pytest.mark.parametrize("kind", LOCAL)
def test_rank_local_coupling_misses_one_process(run, kind):
    """With one coupling rank-local the global losses miss the W = 1 MT
    losses by more than the tolerance: each coupling shows on this batch."""
    res = [r[f"local_{kind}"] for r in run["ranks"] if "ref_losses" in r[f"local_{kind}"]]
    assert len(res) == 1
    got, want = res[0]["losses"], res[0]["ref_losses"]
    rel = D.loss_rel(got, {k: want[k] for k in got})
    assert max(rel.values()) > 10 * D.LOSS_RTOL, rel
