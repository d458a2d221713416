"""Data parallelism at one image a rank: the port's four gloo ranks on the
CPU against JAX's own mesh of four host devices.

On four cards at one image a rank, the float32 supervised step moved one
tensor, ``roi_heads.box.predictor.bbox_pred.weight``, 2% past the bound of
the data-parallel check (1e-4 of its norm + 1e-6) from one process's step
on the global batch. Here both packages take the same supervised step on
the same weights and the same global batch of 4 images (the flagship graph
at a 128 canvas in float32, ``torch_port_util.TRAIN_SMALL``'s counts, the
relation head's geometric gate off its pole, ``same_draws``'s table):

* JAX, under ``tests/conftest.py``'s 8 forced host devices, on a mesh of 4
  devices against a mesh of 1 (as tests/test_parallel_trainer.py:56 does
  with 8): its losses within 2e-5 relative, and the move of each updated
  tensor, ||p_4 - p_1||, which is JAX's own spread at one image a device;
* the port, 4 gloo ranks of one image each (``torch_port_dist.moves_rank``,
  PyTorch's own convolution) against one process on the global batch: the
  ranks bit-identical, the losses within 2e-5 relative, and each updated
  tensor's move within the larger of 1e-4 of its norm + 1e-6 and JAX's own
  move of that tensor. The JAX and port moves of ``bbox_pred.weight`` are
  printed (``-s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist as D
import torch_port_util as U
from mmt_psm_tpu.config import get_cfg as jax_get_cfg
from mmt_psm_tpu.parallel import make_mesh, replicate, shard_batch
from mmt_psm_tpu.train.optim import make_optimizer
from mmt_psm_tpu.train.supervised import create_train_state, make_supervised_step
from mmt_psm_tpu_torch.data.synthetic import generate_batch
from mmt_psm_tpu_torch.utils.jax_params import flax_key, load_jax_params

U.setup_torch()

WORLD = 4
START_MT = 1000
BBOX = "roi_heads.box.predictor.bbox_pred.weight"
LOSS_RTOL = 2e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_one_image")
    labeled = generate_batch(0, WORLD, image_size=128, max_instances=U.MAX_GT)
    with pytest.MonkeyPatch.context() as mp:
        U.same_draws(mp, batch=WORLD)
        jm, _, tm, flat = U.build_pair(**U.TRAIN_SMALL)
        flat["relation_nms/relation_module/WG.bias"] = np.full_like(flat["relation_nms/relation_module/WG.bias"],
                                                                   D.WG_BIAS)
        load_jax_params(tm, flat)
        pair_path = str(tmp / "pair.pt")
        torch.save({"config": tm.config, "student": tm.state_dict(), "teacher": tm.state_dict()}, pair_path)
        job = {"build": {"state": pair_path, "opts": ["SOLVER.IMS_PER_BATCH", str(WORLD)]}, "draws": "table",
               "labeled": labeled, "iteration": START_MT}
        world = D.World(D.moves_rank, WORLD, tmp / "world", args=(job,), timeout=900)
        try:
            assert jax.device_count() >= WORLD
            jcfg = jax_get_cfg()
            jcfg.merge_from_file(U.FLAGSHIP)
            params = U.unflatten(flat)
            tx, _ = make_optimizer(jcfg, params)
            step = jax.jit(make_supervised_step(jm, tx))
            batch = U.train_batch(0, WORLD)
            jax_runs = {}
            for n in (1, WORLD):
                mesh = make_mesh(n)
                state = replicate(create_train_state(params, tx), mesh)
                sharded = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
                with mesh:
                    state, metrics = step(state, sharded, replicate(jax.random.PRNGKey(0), mesh))
                jax_runs[n] = ({k: float(v) for k, v in metrics.items()},
                               U.flatten(jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))))
        except BaseException:
            world.kill()
            raise
    ranks = world.wait()
    (loss_1, p_1), (loss_n, p_n) = jax_runs[1], jax_runs[WORLD]
    jax_moves = {k: float(np.linalg.norm(p_n[k].astype(np.float64) - p_1[k])) for k in p_1}
    return {"ranks": ranks, "jax_losses": (loss_1, loss_n), "jax_moves": jax_moves,
            "jax_norms": {k: float(np.linalg.norm(v.astype(np.float64))) for k, v in p_1.items()}}


def test_jax_mesh_of_four_against_one(run):
    loss_1, loss_n = run["jax_losses"]
    assert sorted(loss_1) == sorted(loss_n)
    for k, w in loss_1.items():
        assert abs(loss_n[k] - w) <= LOSS_RTOL * abs(w), (k, loss_n[k], w)
    moves, norms = run["jax_moves"], run["jax_norms"]
    key = flax_key(BBOX)[0]
    assert all(np.isfinite(v) for v in moves.values())
    print(f"\nJAX mesh {WORLD} vs 1, one image a device: {key} moved {moves[key]:.6g} "
          f"(norm {norms[key]:.6g}; 1e-4 of it + 1e-6 = {1e-4 * norms[key] + 1e-6:.6g})")


def test_four_ranks_within_jax_spread(run):
    ranks = run["ranks"]
    assert all(r["identical"] for r in ranks)
    r0 = ranks[0]
    for k, w in r0["ref_losses"].items():
        assert abs(r0["losses"][k] - w) <= LOSS_RTOL * abs(w), (k, r0["losses"][k], w)
    over = {}
    for name, (move, norm) in r0["moves"].items():
        key = flax_key(name)[0]
        bound = max(1e-4 * norm + 1e-6, run["jax_moves"].get(key, 0.0))
        if not move <= bound:
            over[name] = (move, bound)
    assert not over, over
    move, norm = r0["moves"][BBOX]
    print(f"\nport {WORLD} gloo ranks vs one process, one image a rank: {BBOX} moved {move:.6g} (norm {norm:.6g}); "
          f"JAX's own move {run['jax_moves'][flax_key(BBOX)[0]]:.6g}")
