"""Whether the JAX package and the port diverge on one repeated batch, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/mt_divergence_witness.py [--steps 40] [--seed 0] [--threads 4]
        [--out FILE]

Both packages build the flagship's training graph (configs/pap/mmt_psm_r50_fpn.yaml,
hint adaptor included) at a 128 canvas in float32, batch 2, from one set of random
weights: the JAX train CLI's init from PRNGKey(0) (tools/train_mean_teacher.py),
loaded into the port through ``utils/jax_params.load_jax_params``, the teacher a
copy of the student. Both take the same labeled and unlabeled batch, the first of
the port's train CLI's ``--synthetic`` loaders (identical to the JAX CLI's), and
run ``--steps`` mean-teacher steps on that one pair from iteration START_MT + 1,
each package with its own random draws from ``--seed`` (the JAX step's key
and the port's ``torch.Generator``; the two cannot give the same sampler
draws, so the runs part after the first step). The weights do not depend on
``--seed``.

After each step it reads the losses and whether every updated parameter is
finite. A step is non-finite when a loss or a parameter is; on the CPU an index
out of range raises where the card would stop with a device-side assert, and the
port's run counts that step as its first non-finite one too. Prints one JSON
object: for each package the first non-finite step (null if none), the error if
one was raised, and every loss of every step; ``--out`` also writes it there.
This script imports both packages and is not part of the port.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FLAGSHIP = os.path.join(REPO, "configs", "pap", "mmt_psm_r50_fpn.yaml")
SIZE, BATCH = 128, 2
OPTS = ["TPU.IMAGE_SIZE", SIZE, "TPU.COMPUTE_DTYPE", "float32", "SOLVER.IMS_PER_BATCH", BATCH]


def flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix) + "." + k] = v
    return out


def first_batches(opts):
    """The first labeled and unlabeled batch (numpy) of the train CLI's
    ``--synthetic`` loaders at the config of ``opts``."""
    from mmt_psm_tpu_torch.data.loader import make_source_loader, make_unlabeled_loader
    from mmt_psm_tpu_torch.models.detector import load_config
    from mmt_psm_tpu_torch.tools.train_mean_teacher import build_data

    cfg = load_config(FLAGSHIP, opts)
    canvas, batch = int(cfg.TPU.IMAGE_SIZE), int(cfg.SOLVER.IMS_PER_BATCH)
    source_ds, unlabeled_ds, min_size = build_data(cfg, True, canvas)
    lab = next(make_source_loader(source_ds, batch, canvas, max_gt=cfg.TPU.MAX_GT, min_size=min_size,
                                  max_size=canvas))
    unl = next(make_unlabeled_loader(unlabeled_ds, batch, canvas, aug_k=cfg.MT.AUG_K, aug_s=cfg.MT.AUG_S,
                                     min_size=min_size, max_size=canvas))
    return lab, unl


def jax_init(opts, lab):
    """(the JAX config tree, model and its parameters): the JAX train CLI's
    init from PRNGKey(0) on the labeled batch ``lab``."""
    import jax
    import jax.numpy as jnp

    from mmt_psm_tpu.config import get_cfg
    from mmt_psm_tpu.models import MaskRCNN, ModelConfig
    from mmt_psm_tpu.train.supervised import batch_to_gt

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(list(opts))
    model = MaskRCNN(config=ModelConfig.from_cfg(cfg))
    b0 = {k: jnp.asarray(v) for k, v in lab.items()}
    init_fn = jax.jit(lambda rngs, img, sz, gt: model.init(rngs, img, sz, gt, method=model.init_all))
    params = init_fn({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
                      "dropout": jax.random.PRNGKey(2)}, b0["image"], b0["image_size"], batch_to_gt(b0))["params"]
    return cfg, model, params


def run_jax(opts, lab, unl, steps: int, seed: int):
    import jax
    import jax.numpy as jnp

    from mmt_psm_tpu.train.mt_step import MTConfig, make_mt_step
    from mmt_psm_tpu.train.optim import make_optimizer
    from mmt_psm_tpu.train.supervised import create_train_state

    cfg, model, params = jax_init(opts, lab)
    b0 = {k: jnp.asarray(v) for k, v in lab.items()}
    mt = MTConfig.from_cfg(cfg)
    tx, _ = make_optimizer(cfg, params)
    state = create_train_state(params, tx, with_teacher=True).replace(step=jnp.asarray(mt.start_mt + 1, jnp.int32))
    mt_step = make_mt_step(model, tx, mt)

    @jax.jit
    def step(state, batch, ub, rng):
        state, metrics = mt_step(state, batch, ub, rng)
        finite = jnp.all(jnp.stack([jnp.all(jnp.isfinite(x)) for x in jax.tree_util.tree_leaves(state.params)]))
        return state, metrics, finite

    ub = {k: jnp.asarray(v) for k, v in unl.items()}
    rng = jax.random.PRNGKey(seed)
    init = flatten(jax.device_get(params))
    record = {"first_non_finite": None, "error": None, "losses": {}}
    for i in range(steps):
        state, metrics, finite = step(state, b0, ub, rng)
        metrics = jax.device_get(metrics)
        for k, v in metrics.items():
            record["losses"].setdefault(k, []).append(float(v))
        if not (bool(finite) and all(math.isfinite(float(v)) for v in metrics.values())):
            record["first_non_finite"] = i
            break
    return record, init


def port_trainer(opts, flat, seed: int):
    """The port's MT trainer on the CPU at iteration START_MT + 1, the
    student and teacher the JAX init ``flat``, draws from ``seed``."""
    import numpy as np
    import torch

    from mmt_psm_tpu_torch.train import build_mt_trainer
    from mmt_psm_tpu_torch.utils.jax_params import load_jax_params

    tr = build_mt_trainer(device="cpu", seed=seed, opts=list(opts))
    load_jax_params(tr.model, {k: np.asarray(v) for k, v in flat.items()})
    with torch.no_grad():
        for t, s in zip(*tr.ema_pairs):
            t.copy_(s)
    tr.iteration = tr.mt.start_mt + 1
    return tr


def run_port(opts, lab, unl, steps: int, flat, seed: int, trainer=None):
    """``steps`` MT steps of the port (of ``trainer``, default
    ``port_trainer``'s) on the one batch pair."""
    import numpy as np
    import torch

    tr = trainer or port_trainer(opts, flat, seed)
    b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lab.items()}
    ub = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in unl.items()}
    record = {"first_non_finite": None, "error": None, "losses": {}}
    for i in range(steps):
        try:
            out = tr.step(b, ub)
        except (RuntimeError, IndexError) as e:
            record["first_non_finite"], record["error"] = i, f"{type(e).__name__}: {str(e)[:300]}"
            break
        for k, v in out.items():
            record["losses"].setdefault(k, []).append(float(v))
        finite = all(bool(torch.isfinite(p).all()) for p in tr.model.state_dict().values())
        if not (finite and all(bool(torch.isfinite(v)) for v in out.values())):
            record["first_non_finite"] = i
            break
    return record


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    opts = OPTS
    lab, unl = first_batches(opts)
    t = time.perf_counter()
    jax_rec, flat = run_jax(opts, lab, unl, args.steps, args.seed)
    jax_rec["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    port_rec = run_port(opts, lab, unl, args.steps, flat, args.seed)
    port_rec["seconds"] = time.perf_counter() - t
    result = {"steps": args.steps, "size": SIZE, "batch": BATCH, "seed": args.seed, "dtype": "float32",
              "start_iteration": "START_MT + 1", "jax": jax_rec, "port": port_rec}
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
