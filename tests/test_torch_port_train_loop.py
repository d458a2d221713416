"""The port's training loop (``engine/trainer.py::MTTrainer``) against the
JAX package's (``mmt_psm_tpu/engine/trainer.py::MTTrainer``) on the CPU.

* The schedule: both loops over the same iterators across START_MT, with
  CHECKPOINT_PERIOD 2, then a fresh loop that resumes from the tag. The
  steps are recorders, so no JAX step compiles and no model runs: each
  records the iteration, the kind of step and the batches it was given,
  and advances the step counter as a real step does (JAX's
  ``TrainState.step``, the port's ``Trainer.iteration``), which is what a
  save stores and a resume restarts from. Both must take the same steps at
  the same iterations on the same batches, save the same names with the
  same tag after each save, and log at the same iterations with the same
  learning rate.
* Bit-exact resume (the port alone, real steps of the flagship at 128 px in
  float32): 2 straight steps across START_MT against 1 step, its save, a
  fresh trainer that resumes from the tag and takes the second step.
  Parameters, teacher, momentum buffers, the LambdaLR's count and the step
  generator's state must be identical.
* A diverged step (a non-finite loss or gradient norm) stops the loop at
  its loss read with the iteration.
"""

import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.engine import trainer as jtrainer
from mmt_psm_tpu_torch.config import get_cfg
from mmt_psm_tpu_torch.engine import trainer
from mmt_psm_tpu_torch.train.mean_teacher import MTTrainer as StepObject

U.setup_torch()

BATCH = 2
SCHEDULE = ["MT.START_MT", "6", "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.IMS_PER_BATCH", str(BATCH)]


def labeled():
    i = 0
    while True:
        yield {"image": np.full((BATCH, 1), i, np.float32)}
        i += 1


def unlabeled():
    i = 1000
    while True:
        yield {"t_images": np.full((BATCH, 1), i, np.float32)}
        i += 1


def configs(max_iter):
    out = []
    for cfg in (jax_get_cfg(), get_cfg()):
        cfg.merge_from_file(U.FLAGSHIP)
        cfg.merge_from_list(SCHEDULE + ["SOLVER.MAX_ITER", str(max_iter)])
        out.append(cfg)
    return out


def recording_save(loop, tag_file, saves):
    """Wrap ``loop.save`` to record (iteration, final, tag after the save)."""
    real = loop.save

    def save(iteration, final=False):
        real(iteration, final)
        with open(tag_file) as f:
            saves.append((iteration, final, f.read().strip()))

    loop.save = save


def jax_run(cfg, out_dir, steps, saves):
    params = {"w": jnp.zeros((2,), jnp.float32)}
    loop = jtrainer.MTTrainer(None, params, cfg, labeled(), unlabeled(), output_dir=out_dir)

    def sup(state, batch, rng):
        steps.append(("sup", int(state.step), int(batch["image"][0, 0])))
        return state.replace(step=state.step + 1), {"loss_total": jnp.zeros(())}

    def mt(state, batch, ub, rng):
        steps.append(("mt", int(state.step), int(batch["image"][0, 0]), int(ub["t_images"][0, 0])))
        return state.replace(step=state.step + 1), {"loss_total": jnp.zeros(())}

    loop._sup_step, loop._mt_step = sup, mt
    recording_save(loop, os.path.join(out_dir, "last_checkpoint"), saves)
    loop.train(loop.resume() if loop.ckpt_s.has_checkpoint() else 0)


def tiny_step_object(cfg):
    """The port's step object around a 2 x 2 linear model: the loop saves
    and restores its whole payload, which holds no flagship here."""
    model = torch.nn.Linear(2, 2)
    teacher = torch.nn.Linear(2, 2).requires_grad_(False)
    return StepObject(model, teacher, cfg, torch.Generator().manual_seed(0))


def port_run(cfg, out_dir, steps, saves):
    loop = trainer.MTTrainer(tiny_step_object(cfg), labeled(), unlabeled(), output_dir=out_dir)

    def sup(batch):
        steps.append(("sup", loop.steps.iteration, int(batch["image"][0, 0])))
        loop.steps.iteration += 1
        return {"loss_total": torch.zeros(())}

    def mt(batch, ub):
        steps.append(("mt", loop.steps.iteration, int(batch["image"][0, 0]), int(ub["t_images"][0, 0])))
        loop.steps.iteration += 1
        return {"loss_total": torch.zeros(())}

    loop._sup_step, loop._mt_step = sup, mt
    recording_save(loop, os.path.join(out_dir, "last_checkpoint"), saves)
    loop.train(loop.resume() if loop.ckpt.has_checkpoint() else 0)


@pytest.fixture(scope="module")
def schedules(tmp_path_factory):
    """Per package: the steps, the saves, the checkpoint names and the
    logged (iteration, lr) of a run to MAX_ITER 22 and its resume to 26."""
    out = {}
    for name, run in (("jax", jax_run), ("port", port_run)):
        d = str(tmp_path_factory.mktemp(name))
        steps, saves = [], []
        for max_iter in (22, 26):
            cfg = configs(max_iter)[0 if name == "jax" else 1]
            run(cfg, d, steps, saves)
        names = sorted(re.sub(r"\.pth$", "", f) for f in os.listdir(d) if f.startswith(("model_", "t_model_")))
        with open(os.path.join(d, "log.txt")) as f:
            lines = re.finditer(r"iter: (\d+) .* lr: ([\d.]+)", f.read())
            logged = [(int(m.group(1)), float(m.group(2))) for m in lines]
        out[name] = dict(steps=steps, saves=saves, names=names, logged=logged)
    return out


def test_schedule_matches_jax(schedules):
    """Step kinds and their iterations and batches, the saves and the tag
    after each, the checkpoint names (teachers only past START_MT) and the
    resume at the tagged iteration."""
    jx, pt = schedules["jax"], schedules["port"]
    assert pt["steps"] == jx["steps"]
    kinds = [s[0] for s in pt["steps"]]
    assert kinds == ["sup"] * 7 + ["mt"] * 19 and [s[1] for s in pt["steps"]] == list(range(26))
    # the resumed loop restarts its iterators: iteration 22 takes batch 0 again
    assert pt["steps"][22][2:] == (0, 1000)
    assert pt["saves"] == jx["saves"]
    assert pt["saves"][-1] == (26, True, "model_final") and (22, True, "model_final") in pt["saves"]
    assert pt["names"] == jx["names"]
    teachers = [n for n in pt["names"] if n.startswith("t_model_")]
    # START_MT 6 falls on a save: the teacher is saved from iteration 8 on
    assert teachers == [f"t_model_{i:07d}" for i in range(8, 26, 2)] + ["t_model_final"]


def test_logging_matches_jax(schedules):
    """log.txt: a line every 20 iterations and at each run's last, with the
    schedule's learning rate at that iteration."""
    jx, pt = schedules["jax"], schedules["port"]
    assert [i for i, _ in pt["logged"]] == [i for i, _ in jx["logged"]] == [0, 20, 21, 25]
    np.testing.assert_allclose([lr for _, lr in pt["logged"]], [lr for _, lr in jx["logged"]], rtol=0, atol=1e-6)


def test_loop_runs_on_one_device_and_traces(tmp_path, monkeypatch):
    """A TPU.MESH_SHAPE that would leave a rank of the world out raises
    naming both (the world read as 2 here; the data-parallel loop itself is
    held in tests/test_torch_port_dp_loop.py); TPU.PROFILE_DIR writes a
    torch.profiler trace of its window."""
    from mmt_psm_tpu_torch.parallel import comm

    cfg = get_cfg()
    cfg.merge_from_file(U.FLAGSHIP)
    cfg.merge_from_list(["TPU.MESH_SHAPE", "[1]"])
    with monkeypatch.context() as mp:
        mp.setattr(comm, "get_world_size", lambda: 2)
        with pytest.raises(ValueError, match="mesh of 1 device.*world has 2 process"):
            trainer.MTTrainer(tiny_step_object(cfg), labeled())
    prof = tmp_path / "prof"
    cfg.merge_from_list(SCHEDULE + ["TPU.MESH_SHAPE", "[1]", "SOLVER.MAX_ITER", "6", "TPU.PROFILE_DIR", str(prof),
                                    "TPU.PROFILE_START", "1", "TPU.PROFILE_STEPS", "2"])
    steps, saves = [], []
    port_run(cfg, str(tmp_path / "run"), steps, saves)
    assert os.listdir(prof) == ["trace_0000001_0000003.json"]


@pytest.mark.parametrize("what", ["loss_total", "grad_norm"])
def test_diverged_step_raises_with_its_iteration(tmp_path, what):
    """A non-finite loss, or a gradient norm the clip made NaN, stops the
    loop at the read of that step with FloatingPointError naming the
    iteration and the value, before a further step runs; no save follows."""
    cfg = get_cfg()
    cfg.merge_from_file(U.FLAGSHIP)
    cfg.merge_from_list(SCHEDULE + ["SOLVER.MAX_ITER", "8"])
    step_object = tiny_step_object(cfg)
    loop = trainer.MTTrainer(step_object, labeled(), unlabeled(), output_dir=str(tmp_path))
    taken = []

    def sup(batch):
        # a real update of the 2 x 2 model, so the loop reads the clip's norm
        taken.append(step_object.iteration)
        bad = step_object.iteration == 3
        x = torch.full((1, 2), float("nan") if bad and what == "grad_norm" else 1.0)
        loss = step_object.model(x).square().mean()
        step_object.update(loss)
        return {"loss_total": torch.tensor(float("inf") if bad and what == "loss_total" else 0.5)}

    loop._sup_step = sup
    assert step_object.max_norm > 0
    with pytest.raises(FloatingPointError, match=f"iteration 3: the run diverged: {what} (nan|inf)"):
        loop.train(0)
    assert taken == [0, 1, 2, 3]
    assert not os.path.exists(tmp_path / "model_final.pth")


def test_resume_is_bit_exact(tmp_path):
    """k = 1 step, the save, a fresh trainer that resumes, then the second
    step equal 2 straight steps bit for bit; START_MT 0, so the first step is
    supervised and the second, the resumed trainer's one step, the MT step."""
    from mmt_psm_tpu_torch.data.loader import make_source_loader, make_unlabeled_loader
    from mmt_psm_tpu_torch.data.pap import PapUnlabeledDataset, synthetic_slide_dataset
    from mmt_psm_tpu_torch.train import build_mt_trainer

    opts = U.TRAIN_OPTS + ["MT.START_MT", "0", "SOLVER.MAX_ITER", "1", "SOLVER.CHECKPOINT_PERIOD", "0"]
    ds = synthetic_slide_dataset(seed=0, num_slides=2, slide_size=256, win_size=128, overlap=0.5)
    lab = [b for _, b in zip(range(4), make_source_loader(ds, 1, 128, max_gt=8, min_size=128, max_size=128))]
    unl_ds = PapUnlabeledDataset([ds.slides[0][:128, :128], ds.slides[1][:128, :128]])
    unl = [b for _, b in zip(range(2), make_unlabeled_loader(unl_ds, 1, 128, min_size=128, max_size=128))]
    run = str(tmp_path / "run")
    try:
        straight = trainer.MTTrainer(build_mt_trainer(device="cpu", opts=opts), iter(lab), iter(unl), run)
        straight.train(0)  # saves model_final at iteration 1, the tag
        resumed = trainer.MTTrainer(build_mt_trainer(device="cpu", opts=opts), iter(lab[2:]), iter(unl), run)
        assert resumed.resume() == 1
        # the first run drew batch 1 when it stopped, so its iteration 1 takes batch 2
        straight.max_iter = resumed.max_iter = 2
        resumed.train(1)
        straight.train(1)
    finally:
        shutil.rmtree(run, ignore_errors=True)
    a, b = straight.steps, resumed.steps
    assert a.iteration == b.iteration == 2
    for what, x, y in (("student", a.model.state_dict(), b.model.state_dict()),
                       ("teacher", a.teacher.state_dict(), b.teacher.state_dict())):
        assert list(x) == list(y)
        bad = [k for k in x if not torch.equal(x[k], y[k])]
        assert not bad, f"{what} differs at {bad[:5]}"
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and len(sa["state"]) == len(sb["state"]) > 0
    assert all(torch.equal(sa["state"][i]["momentum_buffer"], sb["state"][i]["momentum_buffer"]) for i in sa["state"])
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == 2
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    # the MT step ran: the teacher moved off the student
    assert not all(torch.equal(v, a.model.state_dict()[k]) for k, v in a.teacher.state_dict().items())
