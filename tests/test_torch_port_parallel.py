"""The port's data-parallel layer on the CPU: ``parallel/comm.py`` and
``parallel/mesh.py`` at two gloo ranks, the sharded evaluation against one
process, and ``data/samplers.py`` and ``mesh_size_for`` against the JAX
package's.

* comm at W = 2 (``torch_port_dist.comm_rank``): the barrier, an all-gather
  of payloads of unequal size, ``reduce_loss_dict``, the batch-axis
  collectives (a sum, rows gathered rank-major, a rank's rows of grouped
  rows, the k-th of the union with ties, the batch mean), the bucketed
  gradient sum, ``replicate``, ``shard_batch``, and the Papeval rows of each
  rank's images merged as tests/test_multihost_comm.py merges the JAX
  package's (1e-12);
* ``run_inference`` on 2 ranks, each serving its ``ShardSampler`` share of 7
  windows (one padding repeat, not scored), against one process over all 7:
  every stat within 1e-12, and the overlays and ``.mat`` label maps the
  ranks write into one directory named and filled as one process's. The gt
  are the model's own instances, every other one moved 2 px
  (``chip_smoke.own_instances_as_gt``), so the stats are above 0;
* every sampler yields the JAX package's index sequences from the same
  seeds; ``mesh_size_for`` gives JAX's mesh where that spans the world and
  raises where it would leave a rank out.
"""

import os

import numpy as np
import pytest
import torch

import torch_port_dist as D
import torch_port_util as U
from mmt_psm_tpu.data import samplers as JS
from mmt_psm_tpu_torch.data import samplers as S

U.setup_torch()

EVAL_OPTS = ["TPU.IMAGE_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32", "TPU.MAX_GT", "16",
             "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64", "MODEL.RPN.POST_NMS_TOP_N_TEST", "64",
             "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "64", "MODEL.RELATION_NMS.FIRST_N", "16",
             "MODEL.RELATION_NMS.TOPK", "16"]
EVAL_WINDOWS, EVAL_BATCH, EVAL_VISUAL = 7, 2, 3


@pytest.fixture(scope="module")
def comm_ranks(tmp_path_factory):
    return D.run_world(D.comm_rank, 2, tmp_path_factory.mktemp("comm"), timeout=300)


def test_rank_and_world(comm_ranks):
    assert [(r["world"], r["rank"], r["main"]) for r in comm_ranks] == [(2, 0, True), (2, 1, False)]


def test_all_gather_of_unequal_payloads(comm_ranks):
    for r in comm_ranks:
        assert r["gathered"] == [{"rank": 0, "data": list(range(10))}, {"rank": 1, "data": list(range(20))}]


def test_reduce_loss_dict_averages(comm_ranks):
    for r in comm_ranks:
        assert r["reduced"] == {"loss": 1.5, "acc": 0.5}


def test_batch_axis_collectives(comm_ranks):
    """What one process computes on the ranks' rows put together."""
    union = torch.tensor([5.0, 1.0, 3.0, 3.0, 3.0, 4.0, 3.0, 0.0])
    kth = [torch.sort(union, descending=True)[0][k - 1].item() for k in (1, 3, 5, 8)]
    for rank, r in enumerate(comm_ranks):
        assert r["sum"] == 3 + 7
        assert r["rows"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
        assert r["rank_rows"] == [[0, 1, 4, 5], [2, 3, 6, 7]][rank]
        assert r["kth"] == kth == [5.0, 3.0, 3.0, 0.0]
    # each rank's share of the mean; summed over the ranks, the mean
    assert [r["batch_mean"] for r in comm_ranks] == [3 / 4, 6 / 4]


def test_gradient_sum_and_replicate(comm_ranks):
    for rank, r in enumerate(comm_ranks):
        assert r["replicated"] == ([[1.0, 1.0], [1.0, 1.0]], [0.0, 0.0])
        assert r["grads"] == [[[3.0, 3.0], [3.0, 3.0]], [3.0, 3.0]]
        np.testing.assert_array_equal(r["shard"]["x"], np.arange(8).reshape(4, 2)[2 * rank:2 * rank + 2])
        assert r["shard"]["y"].tolist() == [2 * rank, 2 * rank + 1]


def test_helpers_issue_their_collectives_in_a_group_of_one(tmp_path):
    """``comm.distributed`` read as true in a one-rank gloo group, as
    ``chip_smoke.py`` drives NCCL on one card: every helper issues its
    collective (the step's sums and gathers, the gradient bucket, the loss
    sum, ``all_gather``, the barrier), and the supervised step equals the
    step without collectives (losses 2e-5 relative, the updated tensors
    ``rtol=1e-4, atol=1e-7``)."""
    from unittest import mock

    import torch.distributed as dist

    from mmt_psm_tpu_torch.data.synthetic import batch_to_torch, generate_batch
    from mmt_psm_tpu_torch.engine.trainer import REPLICATED
    from mmt_psm_tpu_torch.parallel import comm
    from mmt_psm_tpu_torch.train import build_trainer

    opts = list(U.TRAIN_OPTS)
    opts[opts.index("SOLVER.IMS_PER_BATCH") + 1] = "2"
    batch = batch_to_torch(generate_batch(0, 2, image_size=128, max_instances=U.MAX_GT), "cpu")

    def step():
        trainer = build_trainer(device="cpu", seed=0, opts=opts)
        losses = comm.global_losses(trainer.step(batch), REPLICATED)
        bucket = sum(t.numel() for t in trainer.clip_tensors)
        return {k: float(v) for k, v in losses.items()}, dict(trainer.model.state_dict()), bucket

    want, want_params, bucket = step()
    reduced, real = [], dist.all_reduce

    def all_reduce(t, *a, **kw):
        reduced.append(t.numel())
        return real(t, *a, **kw)

    comm.init_distributed("gloo", "cpu", rank=0, world_size=1, init_method=f"file://{tmp_path}/store",
                          timeout=D.GROUP_TIMEOUT)
    try:
        with mock.patch.object(comm, "distributed", lambda: True), mock.patch.object(dist, "all_reduce", all_reduce):
            got, params, _ = step()
            gathered = comm.all_gather({"rank": 0})
            comm.synchronize()
    finally:
        dist.destroy_process_group()
    # the normalizers' sums, the k-th's gather, the gradient bucket, the losses
    assert len(reduced) > 3 and bucket in reduced and len(want) in reduced, reduced
    assert gathered == [{"rank": 0}]
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= D.LOSS_RTOL * abs(w), (k, got[k], w)
    assert D.excess(params, want_params)[0] <= 0


def test_sharded_papeval_rows_merge(comm_ranks):
    for r in comm_ranks:
        merged, ref = r["papeval"]
        for key in ("AJI", "F1", "mAP"):
            assert abs(merged[key][1] - ref[key][1]) < 1e-12, key


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    import chip_smoke
    from mmt_psm_tpu_torch.data.loader import make_test_loader
    from mmt_psm_tpu_torch.data.pap import synthetic_slide_dataset
    from mmt_psm_tpu_torch.engine.inference import run_inference
    from mmt_psm_tpu_torch.models.detector import FLAGSHIP_CONFIG, load_config, model_from_cfg

    model = model_from_cfg(load_config(FLAGSHIP_CONFIG, EVAL_OPTS), "cpu", seed=0)
    ds = synthetic_slide_dataset(seed=3, num_slides=2, slide_size=256, win_size=128, overlap=0.0, is_train=False)
    items = chip_smoke.own_instances_as_gt(model, ds, EVAL_BATCH, 128, 16)[:EVAL_WINDOWS]
    two, one = tmp_path_factory.mktemp("eval_files_two"), tmp_path_factory.mktemp("eval_files_one")
    world = D.World(D.eval_rank, 2, tmp_path_factory.mktemp("eval"),
                    args=(items, EVAL_OPTS, EVAL_BATCH, str(two), EVAL_VISUAL), timeout=600)
    try:
        loader = make_test_loader(items, EVAL_BATCH, 128, max_gt=16, min_size=128, max_size=128, raw_u8=True)
        want, timing = run_inference(model, loader, eval_workers=0, prefetch_depth=0, visual_num=EVAL_VISUAL,
                                     visual_dir=str(one / "vis"), mat_dir=str(one / "mat"))
    except BaseException:
        world.kill()
        raise
    return world.wait(), want, timing, (two, one)


def _flat(stats, prefix=""):
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = float(v)
    return out


def test_sharded_run_inference_equals_one_process(eval_runs):
    """Each rank's stats are the whole split's, within 1e-12 of one process
    over every window, and not all 0."""
    ranks, want, timing, _ = eval_runs
    assert timing["images"] == EVAL_WINDOWS
    assert max(want["AJI"].values()) > 0 and want["mAP"]["all"] > 0
    # 7 windows over 2 ranks: rank 1 serves window 0 again as padding and
    # does not score it
    assert [r["served"] for r in ranks] == [[0, 2, 4, 6], [1, 3, 5, 0]]
    assert [r["images"] for r in ranks] == [4, 3]
    flat_want = _flat(want)
    for r in ranks:
        got = _flat(r["stats"])
        assert set(got) == set(flat_want)
        for k, w in flat_want.items():
            assert abs(got[k] - w) <= 1e-12 or (np.isnan(got[k]) and np.isnan(w)), (k, got[k], w)


def test_sharded_run_inference_checks_its_inputs(eval_runs):
    """Batches without each row's dataset index raise on every rank."""
    for r in eval_runs[0]:
        assert "dataset index" in r["no_index"]


def _files(root):
    import scipy.io as sio
    from PIL import Image

    out = {}
    for sub in ("vis", "mat"):
        for f in sorted(os.listdir(root / sub)):
            p = root / sub / f
            out[f"{sub}/{f}"] = np.asarray(Image.open(p)) if f.endswith(".png") else sio.loadmat(p)["predmap"]
    return out


def test_sharded_overlays_and_mat_files_equal_one_process(eval_runs):
    """Two ranks writing into one directory leave the files of one process:
    each named by its dataset index, written once (the padding repeat of
    window 0 is not), the overlays of windows 0-2 alone, the same pixels
    and label maps."""
    two, one = (_files(d) for d in eval_runs[3])
    names = [f"vis/vis_{i:04d}.png" for i in range(EVAL_VISUAL)] + [f"mat/img_{i:04d}.mat" for i in
                                                                     range(EVAL_WINDOWS)]
    assert sorted(one) == sorted(names)
    assert sorted(two) == sorted(one)
    assert any(m.max() > 0 for k, m in one.items() if k.startswith("mat/"))
    for k, want in one.items():
        np.testing.assert_array_equal(two[k], want, err_msg=k)


# --------------------------------------------------------------- samplers
def _take(it, n):
    out = []
    for x in it:
        out.append(x)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n, shards", [(7, 2), (10, 3), (4, 4), (3, 4)])
def test_shard_sampler_matches_jax(n, shards, shuffle):
    for shard in range(shards):
        for epoch in (0, 3):
            got, want = S.ShardSampler(n, shards, shard, shuffle, seed=5), JS.ShardSampler(n, shards, shard, shuffle,
                                                                                          seed=5)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want) and len(got) == len(want)
    # every index is served, the padding repeats the first ones
    served = sorted(i for s in range(shards) for i in S.ShardSampler(n, shards, s, False))
    assert set(served) == set(range(n)) and len(served) == -(-n // shards) * shards
    # the shards' first num_real indices, shuffled or not, serve each index once
    for seed_epoch in (0, 3):
        real = []
        for s in range(shards):
            sampler = S.ShardSampler(n, shards, s, shuffle, seed=5)
            sampler.set_epoch(seed_epoch)
            real += list(sampler)[:sampler.num_real]
        assert sorted(real) == list(range(n))
    with pytest.raises(ValueError):
        S.ShardSampler(n, shards, shards)


@pytest.mark.parametrize("drop_uneven", [False, True])
def test_grouped_and_iteration_batch_samplers_match_jax(drop_uneven):
    groups = np.random.default_rng(0).integers(0, 3, 23)
    for make in (lambda m: m.RandomSampler(23, seed=4), lambda m: m.SequentialSampler(23)):
        got = S.GroupedBatchSampler(make(S), groups, 4, drop_uneven)
        want = JS.GroupedBatchSampler(make(JS), groups, 4, drop_uneven)
        assert len(got) == len(want)
        assert list(got) == list(want)
        assert list(got) == list(want)  # a second pass draws again
        it_got = S.IterationBasedBatchSampler(S.BatchSampler(make(S), 5, drop_uneven), 13, start_iter=2)
        it_want = JS.IterationBasedBatchSampler(JS.BatchSampler(make(JS), 5, drop_uneven), 13, start_iter=2)
        assert list(it_got) == list(it_want) and len(it_got) == 13
    with pytest.raises(ValueError):
        S.GroupedBatchSampler(S.SequentialSampler(4), np.zeros((2, 2)), 2)


@pytest.mark.parametrize("replacement", [True, False])
def test_weighted_sampler_matches_jax(replacement):
    w = np.random.default_rng(1).uniform(0.1, 2.0, 17)
    got = S.WeightedRandomSubsetSampler(w, 9, replacement, seed=3)
    want = JS.WeightedRandomSubsetSampler(w, 9, replacement, seed=3)
    assert _take(got, 9) == _take(want, 9) and list(got) == list(want) and len(got) == 9


# ----------------------------------------------------------------- mesh
@pytest.mark.parametrize("shape, batch, world", [([-1], 4, 1), ([-1], 4, 2), ([-1], 8, 8), ([2], 4, 2),
                                                 ([1], 4, 1), ([4], 8, 4)])
def test_mesh_size_for_matches_jax(monkeypatch, shape, batch, world):
    """Where JAX's rule over ``world`` devices spans them all, the port's
    gives the same mesh."""
    from mmt_psm_tpu.config import get_cfg as jax_get_cfg
    from mmt_psm_tpu.engine import trainer as JT
    from mmt_psm_tpu_torch.config import get_cfg
    from mmt_psm_tpu_torch.parallel import mesh_size_for

    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(["TPU.MESH_SHAPE", str(shape)])
    monkeypatch.setattr(JT.jax, "device_count", lambda: world)
    assert mesh_size_for(cfg, batch, world) == JT.mesh_size_for(jcfg, batch) == world


@pytest.mark.parametrize("shape, batch, world", [([1], 4, 2), ([-1], 3, 2), ([2], 8, 4), ([-1], 6, 4)])
def test_mesh_that_leaves_a_rank_out_raises(monkeypatch, shape, batch, world):
    """Where JAX's rule gives fewer devices than the world (MESH_SHAPE, or a
    batch no shard count divides), the port raises naming both."""
    from mmt_psm_tpu.config import get_cfg as jax_get_cfg
    from mmt_psm_tpu.engine import trainer as JT
    from mmt_psm_tpu_torch.config import get_cfg
    from mmt_psm_tpu_torch.parallel import mesh_size_for

    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(["TPU.MESH_SHAPE", str(shape)])
    monkeypatch.setattr(JT.jax, "device_count", lambda: world)
    n = JT.mesh_size_for(jcfg, batch)
    assert n < world
    with pytest.raises(ValueError, match=f"mesh of {n} device.*world has {world} process"):
        mesh_size_for(cfg, batch, world)


def test_device_for_rank(monkeypatch):
    from mmt_psm_tpu_torch.parallel import comm

    assert comm.device_for_rank("cpu", 3) == torch.device("cpu")
    with pytest.raises(ValueError, match="LOCAL_RANK 1"):
        comm.device_for_rank("cuda:0", 1)
    assert comm.device_for_rank("cuda", 2) == torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.device_for_rank(None, 0)
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        comm.init_distributed("nccl", "cpu", rank=0, world_size=1)
    # at world 1 the helpers are the single-process expressions, no group
    t = torch.tensor([1.0, 2.0])
    assert comm.global_sum(t) is t and comm.gather_rows(t) is t and comm.rank_rows(t) is t
    assert comm.get_world_size() == 1 and comm.all_gather(5) == [5]
