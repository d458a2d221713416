"""Spawned gloo worlds for the port's data-parallel tests on the CPU.

``run_world(fn, world, tmp)`` starts ``world`` spawned processes, each of
which joins a gloo group through a file store in ``tmp`` (no port, so the
xdist workers never collide), calls ``fn(rank, world, *args)`` with one
torch thread, and saves its result with ``torch.save``. Each group has a
timeout, each join a deadline; on a failure or a hang every child is killed
and the test fails with the rank's traceback. This module imports no JAX,
so the ranks start quickly.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback

import pytest
import torch

GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def _rank_main(fn, rank: int, world: int, tmp: str, args) -> None:
    torch.set_num_threads(1)
    from mmt_psm_tpu_torch.parallel import comm

    # the CLIs read a torchrun world from the environment
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    try:
        comm.init_distributed("gloo", "cpu", rank=rank, world_size=world, init_method=f"file://{tmp}/store",
                              timeout=GROUP_TIMEOUT)
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class World:
    """``world`` spawned ranks running ``fn(rank, world, *args)``; ``wait``
    returns their results in rank order."""

    def __init__(self, fn, world: int, tmp, args=(), timeout: float = 600.0):
        self.world, self.tmp, self.timeout = world, str(tmp), timeout
        os.makedirs(self.tmp, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(fn, r, world, self.tmp, args)) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list:
        procs = self.procs
        try:
            # poll, so a rank that fails stops the world at once instead of
            # leaving the others in a collective until the group's timeout
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > self.deadline:
                    break
                time.sleep(0.2)
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed:
                errs = [os.path.join(self.tmp, f) for f in sorted(os.listdir(self.tmp)) if f.endswith(".err")]
                text = "".join(open(e).read() for e in errs)
                pytest.fail(f"a rank exited with {failed[0].exitcode}:\n{text[-4000:]}")
            if any(p.is_alive() for p in procs):
                pytest.fail(f"the {self.world}-rank world did not finish in {self.timeout} s")
        finally:
            self.kill()
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=False) for r in range(self.world)]

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)


def run_world(fn, world: int, tmp, args=(), timeout: float = 600.0) -> list:
    """Every rank's result of ``fn(rank, world, *args)``, in rank order.
    ``fn`` must be importable by the spawned processes (a module-level
    function of a module on ``sys.path``)."""
    return World(fn, world, tmp, args, timeout).wait()


# ------------------------------------------------------------ the ranks' work
# The port's train steps at W = 2 and, inside the same processes, at W = 1
# (``world_one``: the helpers of ``parallel/comm.py`` read the world size at
# each call, so with it patched to 1 they act as in a process without a
# group). Each rank computes the W = 1 reference of its share of the jobs
# and holds the W = 2 result against it; all results are small dicts.

LOSS_RTOL = 2e-5  # tests/test_multihost_train.py's bound on JAX's mesh
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-7
WG_BIAS = 5.0  # the relation head's geometric gate off its pole (torch_port_util)


def world_one():
    from unittest import mock

    from mmt_psm_tpu_torch.parallel import comm

    return mock.patch.multiple(comm, get_world_size=lambda: 1, get_rank=lambda: 0)


def draws_table(batch: int, n: int, seed: int = 0):
    """``torch_port_util.same_draws``'s table of ``batch`` images' draws."""
    import numpy as np

    return np.random.default_rng([seed, n]).uniform(size=(batch, n)).astype(np.float32)


def _table_uniform(gen, shape, device):
    from mmt_psm_tpu_torch.parallel import comm

    shape = tuple(shape)
    return comm.rank_rows(torch.from_numpy(draws_table(comm.global_rows(shape[0]), shape[-1])).to(device))


def _local(kind):
    """The rank-local version of one coupling, for the tests that show the
    data can tell it from the global one."""
    import types
    from unittest import mock

    from mmt_psm_tpu_torch.models import box_head
    from mmt_psm_tpu_torch.ops import sampler
    from mmt_psm_tpu_torch.ops.topk import top_k
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.train import mt_step

    import contextlib

    stack = contextlib.ExitStack()
    if kind == "mean":
        stack.enter_context(mock.patch.multiple(comm, global_sum=lambda t: t, batch_mean=lambda x: x.mean()))
    elif kind == "kth":
        stack.enter_context(mock.patch.object(comm, "global_kth", lambda v, k: top_k(v, min(k, v.shape[0]))[0][-1]))
    elif kind == "psm":
        local = types.SimpleNamespace(global_sum=comm.global_sum, gather_rows=lambda t: t, rank_rows=lambda t: t)
        stack.enter_context(mock.patch.object(mt_step, "comm", local))
    elif kind == "draws":
        local = types.SimpleNamespace(global_sum=comm.global_sum, global_rows=lambda n: n,
                                      rank_rows=lambda t, groups=1: t)
        for mod in (sampler, box_head):
            stack.enter_context(mock.patch.object(mod, "comm", local))
    elif kind is not None:
        raise ValueError(kind)
    return stack


def build_steps(build: dict):
    """A train step object: ``{"state": path}`` (a saved ModelConfig, student
    and teacher, the MT trainer over the flagship config plus ``opts``),
    ``{"opts": [...]}`` (``build_mt_trainer`` from seed 0) or ``{"variant":
    name, "config": ModelConfig, "opts": [...]}`` (a supervised trainer of
    the variant from seed 0)."""
    from mmt_psm_tpu_torch.models import MaskRCNN
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG, load_config
    from mmt_psm_tpu_torch.models.variants import variant_config
    from mmt_psm_tpu_torch.train import MTTrainer, Trainer, build_mt_trainer

    if "state" in build:
        saved = torch.load(build["state"], weights_only=False)
        model, teacher = MaskRCNN(saved["config"]), MaskRCNN(saved["config"])
        model.load_state_dict(saved["student"])
        teacher.load_state_dict(saved["teacher"])
        teacher.eval().requires_grad_(False)
        steps = MTTrainer(model.train(), teacher, load_config(FLAGSHIP_CONFIG, build.get("opts", ())),
                          torch.Generator())
    elif "variant" in build:
        model = MaskRCNN(build["config"])
        model.init_weights(torch.Generator().manual_seed(0))
        cfg = variant_config(build["variant"], build.get("opts", ()))
        steps = Trainer(model, cfg, torch.Generator().manual_seed(0))
    else:
        steps = build_mt_trainer(device="cpu", seed=0, opts=build["opts"])
    with torch.no_grad():
        for m in (steps.model, steps.teacher):
            if m is not None and hasattr(m, "relation_nms"):
                m.relation_nms.relation_module.WG.bias.fill_(WG_BIAS)
    return steps


def _named_grad_tensors(model):
    out = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return out + [(n, b) for n, b in model.named_buffers() if b.requires_grad]


def _summed(losses: dict) -> dict:
    """The losses of the global batch, as the loop sums them."""
    from mmt_psm_tpu_torch.engine.trainer import REPLICATED
    from mmt_psm_tpu_torch.parallel import comm

    return {k: float(v) for k, v in comm.global_losses(losses, REPLICATED).items()}


def run_job(job: dict) -> dict:
    """One step (``update`` True) or the losses alone of a job on this
    rank's rows of its global batch: the losses of the global batch, the
    updated student and teacher, and (``grads``) the gradients the clip
    sees, after the sum over the ranks."""
    # oneDNN picks its convolution's blocking by the batch size, which moves
    # features by ~2e-6 relative between a rank's batch of 1 and one
    # process's batch of 2; PyTorch's own CPU convolution computes each image
    # alone, so with it (``onednn`` False) a step at W = 2 and W = 1 differ
    # only by the order of the sums the data parallelism changes. The JAX
    # comparisons keep oneDNN, as every port-vs-JAX test does: its rounding
    # is XLA's on the CPU
    with torch.backends.mkldnn.flags(enabled=job.get("onednn", False)):
        return _run_job(job)


def _run_job(job: dict) -> dict:
    from unittest import mock

    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, unlabeled_to_torch
    from mmt_psm_tpu_torch.ops import sampler
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.parallel.mesh import current_mesh, shard_batch
    from mmt_psm_tpu_torch.train import supervised

    import contextlib

    steps = build_steps(job["build"])
    mesh = current_mesh("cpu")
    labeled = batch_to_torch(shard_batch(job["labeled"], mesh), "cpu")
    unlabeled = unlabeled_to_torch(shard_batch(job["unlabeled"], mesh), "cpu") if "unlabeled" in job else None
    steps.iteration = job["iteration"]
    grads = {}
    names = {id(t): n for n, t in _named_grad_tensors(steps.model)}

    def record(tensors, max_norm):
        grads.update({names[id(t)]: t.grad.detach().clone() for t in tensors})
        return clip(tensors, max_norm)

    clip = supervised.clip_grad_norm_
    with contextlib.ExitStack() as stack:
        if job.get("draws") == "table":
            stack.enter_context(mock.patch.object(sampler, "uniform", _table_uniform))
        stack.enter_context(_local(job.get("local")))
        if job.get("grads"):
            stack.enter_context(mock.patch.object(supervised, "clip_grad_norm_", record))
        if job.get("update", True):
            losses = steps.step(labeled, unlabeled) if unlabeled is not None else steps.step(labeled)
        else:
            losses = steps.mt_losses(labeled, unlabeled)
    out = {"losses": _summed(losses), "grads": grads}
    if job.get("update", True):
        out["params"] = {k: v.detach().clone() for k, v in steps.model.state_dict().items()}
        out["teacher"] = (None if steps.teacher is None
                          else {k: v.detach().clone() for k, v in steps.teacher.state_dict().items()})
    return out


def excess(got: dict, want: dict, rtol=PARAM_RTOL, atol=PARAM_ATOL, names=None):
    """(The largest |got - want| - atol - rtol |want| over the tensors
    ``names`` (default all), the tensor's name)."""
    worst = (-float("inf"), None)
    for k in want if names is None else names:
        d = (got[k].double() - want[k].double()).abs() - atol - rtol * want[k].double().abs()
        if d.numel():
            worst = max(worst, (float(d.max()), k))
    return worst


def norm_excess(got: dict, want: dict, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    """(The largest ||got - want|| - rtol ||want|| - atol sqrt(n) over the
    tensors, the tensor's name): each tensor to ``rtol`` of its norm, with
    the elementwise ``atol`` for a tensor near 0 (a key bias of the
    relation head, whose softmax makes its gradient 0 up to rounding)."""
    worst = (-float("inf"), None)
    for k, w in want.items():
        d = float((got[k].double() - w.double()).norm()) - rtol * float(w.double().norm()) - atol * w.numel() ** 0.5
        worst = max(worst, (d, k))
    return worst


FC6 = ("roi_heads.box.feature_extractor.fc6.weight", "roi_heads.box.feature_extractor.fc6.bias")


def loss_rel(got: dict, want: dict) -> dict:
    return {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()}


def ranks_identical(state: dict) -> bool:
    """Whether every rank holds rank 0's tensors, bit for bit."""
    flat = torch.cat([v.reshape(-1).float() for v in state.values()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0)
    same = torch.tensor([int(torch.equal(flat, ref))])
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item())


def steps_rank(rank: int, world: int, jobs: dict, checks: dict, keep: tuple = ()) -> dict:
    """Run ``jobs`` (name -> job) at W = ``world`` and hold each against its
    W = 1 reference, computed in this process by the rank ``checks[name]``
    names (the other ranks hold the same W = 2 state). The jobs go in groups
    of ``world``, whose references the ranks compute side by side. A job
    without a check of its own is held against the reference of
    ``job["against"]``. Returns per job the W = 2 losses, whether the ranks'
    states are identical, and on the checking rank the reference's losses
    and the largest excess of the student's and teacher's tensors over the
    bounds (``excess``, ``norm_excess``); on rank 0 the gradients of the
    jobs in ``keep``."""
    out, refs, names = {}, {}, list(jobs)
    for start in range(0, len(names), world):
        group = names[start:start + world]
        for name in group:
            if checks.get(name) == rank:
                with world_one():
                    refs[name] = run_job(dict(jobs[name], local=None))
        for name in group:
            job = jobs[name]
            got = run_job(job)
            res = {"losses": got["losses"]}
            if "params" in got:
                res["identical"] = ranks_identical(got["params"]) and (
                    got["teacher"] is None or ranks_identical(got["teacher"]))
            ref = refs.get(name, refs.get(job.get("against")))
            if ref is not None:
                res["ref_losses"] = ref["losses"]
                if "params" in got:
                    for key in ("params", "teacher"):
                        if got[key] is not None:
                            res[f"{key}_excess"] = excess(got[key], ref[key])
                            fc6 = [n for n in FC6 if n in ref[key]]
                            res[f"{key}_fc6_excess"] = excess(got[key], ref[key], names=fc6) if fc6 else None
                            res[f"{key}_norm_excess"] = norm_excess(got[key], ref[key])
            if name in keep and rank == 0:
                res["grads"] = got["grads"]
            out[name] = res
        later = {jobs[n].get("against") for n in names[start + world:]}
        for name in group:
            if name not in later:
                refs.pop(name, None)
    return out


def moves_rank(rank: int, world: int, job: dict) -> dict:
    """One job at W = ``world`` and, on rank 0, at W = 1 on the global batch
    (``world_one``): whether the ranks' updated students are bit-identical;
    on rank 0 also both runs' losses and, per tensor of the student, the
    norm of the W = ``world`` step's move from the W = 1 step and the W = 1
    tensor's norm."""
    if rank == 0:
        with world_one():
            ref = run_job(dict(job, local=None))
    got = run_job(job)
    out = {"identical": ranks_identical(got["params"])}
    if rank == 0:
        out.update(losses=got["losses"], ref_losses=ref["losses"],
                   moves={k: (float((got["params"][k].double() - w.double()).norm()), float(w.double().norm()))
                          for k, w in ref["params"].items()})
    return out


def comm_rank(rank: int, world: int) -> dict:
    """``parallel/comm.py`` and ``parallel/mesh.py`` at W = ``world``: each
    helper's result on this rank (the test holds them to the
    single-process values)."""
    import numpy as np
    from torch import nn

    from mmt_psm_tpu_torch.evaluation.instmask import InstSeg
    from mmt_psm_tpu_torch.evaluation.pap_eval import PapEvaluator
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.parallel.mesh import current_mesh, replicate, shard_batch

    out = {"world": comm.get_world_size(), "rank": comm.get_rank(), "main": comm.is_main_process()}
    comm.synchronize()
    out["gathered"] = comm.all_gather({"rank": rank, "data": list(range(10 * (rank + 1)))})
    out["reduced"] = comm.reduce_loss_dict({"loss": 1.0 + rank, "acc": 0.5})
    out["sum"] = comm.global_sum(torch.tensor(3 + 4 * rank)).item()
    local = torch.arange(3, dtype=torch.float32) + 10 * rank
    out["rows"] = comm.gather_rows(local).tolist()
    out["rank_rows"] = comm.rank_rows(torch.arange(4 * world), groups=2).tolist()
    # ties across the ranks: the k-th of the union, >= keeps every tie
    values = torch.tensor([[5.0, 1.0, 3.0, 3.0], [3.0, 4.0, 3.0, 0.0]][rank])
    out["kth"] = [comm.global_kth(values, k).item() for k in (1, 3, 5, 8)]
    out["batch_mean"] = comm.batch_mean(torch.tensor([1.0, 2.0]) * (rank + 1)).item()
    lin = nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1.0)
        lin.bias.fill_(-rank)
    replicate(lin, current_mesh("cpu"))
    out["replicated"] = (lin.weight.tolist(), lin.bias.tolist())
    for p in lin.parameters():
        p.grad = torch.full_like(p, rank + 1.0)
    comm.all_reduce_grads_(list(lin.parameters()))
    out["grads"] = [p.grad.tolist() for p in lin.parameters()]
    out["shard"] = shard_batch({"x": np.arange(8).reshape(4, 2), "y": torch.arange(4)}, current_mesh("cpu"))

    # the sharded eval's merge: each rank scores its images, the rows gather
    # in rank order (tests/test_multihost_comm.py's check of the JAX package)
    def make(seed):
        r = np.random.default_rng(seed)
        masks = np.zeros((3, 64, 64), bool)
        for i in range(3):
            y, x = r.integers(8, 48, 2)
            masks[i, y:y + 12, x:x + 12] = True
        return {1: InstSeg.from_full_masks(masks, scores=r.uniform(0.2, 1, 3))}, {1: InstSeg.from_full_masks(
            masks[::-1].copy())}

    ev = PapEvaluator(categories=(1,))
    for seed in (rank * 2, rank * 2 + 1):
        ev.add_image(*make(seed))
    merged = PapEvaluator(categories=(1,))
    merged.results = [row for rows in comm.all_gather(ev.results) for row in rows]
    ref = PapEvaluator(categories=(1,))
    for seed in range(2 * world):
        ref.add_image(*make(seed))
    out["papeval"] = (merged.summarize(), ref.summarize())
    comm.synchronize()
    return out


def eval_rank(rank: int, world: int, items, opts, batch: int, out_dir: str, visual_num: int) -> dict:
    """``run_inference`` at W = ``world``, each rank serving its
    ``ShardSampler`` share of ``items`` (no shuffle) with the model of the
    flagship config plus ``opts`` from seed 0, every rank writing the
    overlays of the first ``visual_num`` images and every ``.mat`` into
    ``out_dir``'s ``vis`` and ``mat``, as the test CLI's ranks share them."""
    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.data.samplers import ShardSampler
    from mmt_psm_tpu_torch.engine.inference import run_inference
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG, load_config, model_from_cfg

    model = model_from_cfg(load_config(FLAGSHIP_CONFIG, opts), "cpu", seed=0)
    canvas = model.config.image_size
    shard = ShardSampler(len(items), world, rank, shuffle=False)
    loader = make_test_loader(items, batch, canvas, max_gt=16, min_size=canvas, max_size=canvas, raw_u8=True,
                              indices=shard)
    stats, timing = run_inference(model, loader, eval_workers=0, prefetch_depth=0, visual_num=visual_num,
                                  visual_dir=os.path.join(out_dir, "vis"), mat_dir=os.path.join(out_dir, "mat"))
    try:
        run_inference(model, make_test_loader(items[:2], batch, canvas, max_gt=16, min_size=canvas, max_size=canvas,
                                              raw_u8=True), eval_workers=0, prefetch_depth=0)
        no_index = None
    except ValueError as e:
        no_index = str(e)
    return {"stats": stats, "images": timing["images"], "served": list(shard), "no_index": no_index}


def cli_run(root: str, opts, weights: str, test_cli: bool = True) -> dict:
    """The train CLI from ``weights`` for 2 iterations into ``root/run``
    (the val sweep after them), then resumed for a third, past START_MT 1,
    with ``--skip-test``, then (``test_cli``) the test CLI over its
    ``model_final`` alone in ``root/ckpt``; with PyTorch's own CPU
    convolution. Returns each iteration's losses (as the loop logged them),
    where each run began, the val summary and the test CLI's results."""
    import shutil

    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.tools import train_mean_teacher

    run, ckpt = os.path.join(root, "run"), os.path.join(root, "ckpt")
    base = ["--synthetic", "--device", "cpu", "--weights", weights, "--output-dir", run]
    with torch.backends.mkldnn.flags(enabled=False):
        first = train_mean_teacher.main(base + list(opts) + ["SOLVER.MAX_ITER", "2"])
        losses = {k: list(m.deque) for k, m in first["trainer"].meters.meters.items() if k != "time"}
        second = train_mean_teacher.main(base + ["--skip-test"] + list(opts) + ["SOLVER.MAX_ITER", "3"])
        resumed = {k: list(m.deque) for k, m in second["trainer"].meters.meters.items() if k != "time"}
        tested = None
        if test_cli:
            if comm.is_main_process():
                os.makedirs(ckpt)
                shutil.copy(os.path.join(run, "model_final.pth"), ckpt)
            comm.synchronize()
            tested = test_net_run(ckpt, opts)
    return {"losses": losses, "resumed": resumed, "starts": (first["start_iter"], second["start_iter"]),
            "final_eval": first["final_eval"], "tested": tested}


def cli_rank(rank: int, world: int, root: str, opts, weights: str) -> dict:
    """``cli_run`` at W = ``world``, every rank in the same ``root``."""
    return cli_run(root, opts, weights)


def test_net_run(ckpt: str, opts) -> dict:
    """The test CLI over the checkpoints in ``ckpt``, with PyTorch's own CPU
    convolution."""
    from mmt_psm_tpu_torch.tools import test_net

    with torch.backends.mkldnn.flags(enabled=False):
        return test_net.main(["--synthetic", "--ckpt-dir", ckpt, "--device", "cpu", *opts])
