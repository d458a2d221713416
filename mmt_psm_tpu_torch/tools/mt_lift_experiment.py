"""Semi-supervised lift experiment: supervised-only against full MMT-PSM
(the port's copy of ``scripts/mt_lift_experiment.py``).

    python -m mmt_psm_tpu_torch.tools.mt_lift_experiment [--iters 1800] [--start-mt 400] [--size 256]
        [--arms sup,mt,odkd,psm,mgd,oracle] [--sharpen] [--hard-neg] [--seed S] [--out F]
        [--init-from SAVE] [--tag T] [--ckpt-period 600] [--device cpu] ...

The reference exists to show that the mean-teacher loop (PSM + MGD and the
EMA teacher, engine/MTtrainer.py:111-281, box_head/loss.py:185-237,
generalized_rcnn.py:243-282) buys accuracy from unlabeled data. This tool
trains on synthetic Pap slides, every array made from seeds:

* a small labeled split (the first ``--train-ratio`` of one slide's
  windows), on which a supervised model overfits;
* a large pool of unlabeled patches from the same generator;
* the arms, from one seeded init and one schedule: ``sup`` (LAMBDA 0),
  ``mt`` (PSM + MGD past START_MT), and on request ``odkd`` (the distillation
  baseline: single-view soft CE and an unmasked hint), ``psm`` (FG_HINT 0),
  ``mgd`` (CLS_LOSS 0) and ``oracle`` (supervised on ``--oracle-slides``
  fully labeled slides);
* each arm's student, and the teacher of each mean-teacher arm, scored on
  8 held-out slides by ``run_inference`` and Papeval.

The model is the plain Mask R-CNN R-50-FPN with the greedy post-processor
and the JAX script's reduced proposal counts (``LIFT_MODEL``), bf16, with
the MGD hint adaptor in training when ``--fg-hint`` > 0. Each arm runs
``engine/trainer.py::MTTrainer`` in ``<tmp>/mt_lift_<arm>[_s<seed>][_<tag>]``
(``tempfile.gettempdir()``, /tmp unless TMPDIR says otherwise), saving every
``--ckpt-period`` iterations and resuming from the directory's tag; a
resumed run restarts its loaders from their seeds, as the JAX run does. The
final student and teacher are saved there as ``<arm>_final_student`` and
``<arm>_final_teacher`` (``{"model": state_dict}``), which
``tools/eval_lift_checkpoint.py`` scores and ``--init-from`` loads (an orbax
directory of the JAX package raises). The JSON written to ``--out`` holds
the JAX script's keys; on a card ``meta`` also holds the card's name and
power limit under ``card``.

The JAX script's flags, with ``--device`` in place of ``--cpu``: the card
unless ``--device`` names another device. The JAX package draws its init,
sampling and dropout from ``jax.random``; the port draws them from torch
generators, so its numbers sit near JAX's, not on them.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import numpy as np
import torch

# the JAX script's ModelConfig overrides (scripts/mt_lift_experiment.py:36-48);
# the plain Mask R-CNN: neither relation head
LIFT_MODEL = dict(
    pre_nms_top_n_train=1024,
    pre_nms_top_n_test=512,
    post_nms_top_n_train=512,
    post_nms_top_n_test=512,
    fpn_post_nms_top_n_train=1024,
    fpn_post_nms_top_n_test=512,
    box_batch_per_image=256,
    mask_max_pos=64,
    detections_per_img=100,
    with_relation_nms=False,
    relation=None,
    with_relation_mask=False,
    relation_mask=None,
)
MT_ARMS = ("mt", "odkd", "psm", "mgd")
MAX_GT = 64
# the step draws' seed: the JAX loop keys every run's steps with PRNGKey(0)
STEP_SEED = 0


def lift_model_config(size: int, with_hint: bool = False):
    from ..models.detector import ModelConfig

    return ModelConfig(image_size=size, with_hint_adaptor=with_hint, **LIFT_MODEL)


def build_model(size: int, with_hint: bool = False):
    """(model, its ModelConfig): the lift's graph at canvas ``size`` on the
    CPU, eval mode, weights not yet initialised."""
    from ..models.detector import MaskRCNN

    mcfg = lift_model_config(size, with_hint)
    return MaskRCNN(mcfg), mcfg


def init_model(model, seed: int = 0):
    """The port's seeded init (``MaskRCNN.init_weights``) of a model on the
    CPU: every submodule the JAX ``init_all`` touches, the hint adaptor
    included."""
    return model.init_weights(torch.Generator().manual_seed(seed))


def evaluate(model, loader) -> dict:
    """The held-out numbers of ``model`` (JAX keys, rounded to 4 places)."""
    from ..engine.inference import run_inference

    model.eval()
    stats, _ = run_inference(model, loader)
    return {
        "AJI_cyto": round(float(stats["AJI"].get(1, 0.0)), 4),
        "AJI_nuclei": round(float(stats["AJI"].get(2, 0.0)), 4),
        "mAP_all": round(float(stats["mAP"].get("all", -1)), 4),
        "AP50_all": round(float(stats["AP50"].get("all", -1)), 4),
        "F1_nuclei": round(float(stats["F1"].get(2, 0.0)), 4),
    }


def load_saved_weights(path: str) -> dict:
    """The ``state_dict`` of a port save named by ``path`` (``<dir>/<name>``
    or ``<dir>/<name>.pth``): a final save, a ``t_model_*`` or a
    ``model_*`` resume payload, each holding it under ``"model"``."""
    from ..utils.checkpoint import Checkpointer

    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax save of the JAX package?): the port loads its own "
                         f"saves, <dir>/<name>.pth")
    d, name = os.path.split(path[: -len(".pth")] if path.endswith(".pth") else path)
    if not os.path.exists(os.path.join(d or ".", f"{name}.pth")):
        raise FileNotFoundError(f"no port save {os.path.join(d or '.', name + '.pth')}")
    tree = Checkpointer(d or ".").load(name)
    if not isinstance(tree, dict) or "model" not in tree:
        raise ValueError(f"{path} holds no 'model' state_dict")
    return tree["model"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="semi-supervised lift: supervised-only against MMT-PSM")
    ap.add_argument("--iters", type=int, default=1800)
    ap.add_argument("--start-mt", type=int, default=400)
    ap.add_argument("--size", type=int, default=256)
    # model canvas (0: --size); the flagship regime windows at 1000 on a 1024 canvas
    ap.add_argument("--canvas", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--labeled-slides", type=int, default=1)
    # the first fraction of the labeled slide's windows (Pap.py:494-496)
    ap.add_argument("--train-ratio", type=float, default=0.45)
    ap.add_argument("--unlabeled-patches", type=int, default=192)
    # MGD's foreground-hint weight of the reference authors' run names
    ap.add_argument("--fg-hint", type=float, default=0.05)
    # an upper-bound arm, supervised on this many fully labeled slides (0: none)
    ap.add_argument("--oracle-slides", type=int, default=0)
    # the authors' trained LAMBDA (their run names record la2.0)
    ap.add_argument("--lambda", dest="lam", type=float, default=2.0)
    # the reference's trained EMA rate (scripts/train_mt.sh MT.ALPHA 0.99)
    ap.add_argument("--alpha", type=float, default=0.99)
    # PSM's sharpened soft targets and highest-std hard negatives
    ap.add_argument("--sharpen", action="store_true")
    ap.add_argument("--hard-neg", action="store_true")
    # comma-separated subset of {sup,mt,oracle,odkd,psm,mgd} to run
    ap.add_argument("--arms", type=str, default="")
    # shifts the labeled and unlabeled generators and the init together (the
    # held-out slides keep their seed, so replicas share them)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "mt_lift.json"))
    # every arm starts from a port save (e.g. an oracle arm's final student
    # trained on other slide seeds) instead of the seeded init
    ap.add_argument("--init-from", type=str, default="")
    # a checkpoint-directory suffix, so a variant run never resumes from another's saves
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--ckpt-period", type=int, default=600)
    ap.add_argument("--device", type=str, default=None, help="torch device; default: the card")
    return ap.parse_args(argv)


def arm_config(args, arm: str):
    """The config of one arm (the JAX script's ``make_cfg``,
    scripts/mt_lift_experiment.py:194-230)."""
    from ..config import get_cfg

    with_mt, odkd = arm in MT_ARMS, arm == "odkd"
    cfg = get_cfg()
    cfg.SOLVER.BASE_LR = args.lr
    cfg.SOLVER.MAX_ITER = args.iters
    cfg.SOLVER.STEPS = (int(args.iters * 0.75),)
    cfg.SOLVER.WARMUP_ITERS = min(100, args.iters // 5)
    cfg.SOLVER.IMS_PER_BATCH = args.batch
    cfg.SOLVER.CHECKPOINT_PERIOD = args.ckpt_period
    cfg.MT.LAMBDA = args.lam if with_mt else 0.0
    # the odkd arm swaps MGD for the baseline's unmasked hint (the paper's
    # ODKD-without-MGD row)
    cfg.MT.FG_HINT = args.fg_hint if (with_mt and not odkd) else 0.0
    # the component arms: psm without MGD's hint; mgd without PSM's loss
    # (CLS_LOSS gates mt_classifier, box_head/loss.py:185-237)
    if arm == "psm":
        cfg.MT.FG_HINT = 0.0
    elif arm == "mgd":
        cfg.MT.CLS_LOSS = 0.0
    cfg.MT.SHARPEN = bool(args.sharpen)
    cfg.MT.HARD_NEG = bool(args.hard_neg)
    cfg.MT.ALPHA = args.alpha
    cfg.MT.START_MT = args.start_mt
    cfg.MT.RAMPUP_STEP = max(args.iters // 6, 50)
    cfg.MT.RAMPDOWN_STEP = max(args.iters // 6, 50)
    cfg.MT.MAX_ITER = args.iters
    cfg.MT.ODKD = bool(odkd)
    return cfg


def lift_data(args):
    """(labeled windows, unlabeled patches, held-out windows), from the JAX
    script's seeds (scripts/mt_lift_experiment.py:173-187)."""
    from ..data.pap import PapUnlabeledDataset, synthetic_slide_dataset
    from ..data.synthetic import generate_sample

    size = args.size
    train_ds = synthetic_slide_dataset(seed=args.seed, num_slides=args.labeled_slides, slide_size=2 * size,
                                       win_size=size, overlap=0.5, train_ratio=args.train_ratio)
    rng = np.random.default_rng(50 + args.seed)
    patches = [generate_sample(rng, image_size=size, max_instances=64, num_cells=(4, 10)).image.astype(np.uint8)
               for _ in range(args.unlabeled_patches)]
    return train_ds, PapUnlabeledDataset(patches), held_out(size)


def held_out(size: int):
    """The lift's held-out split: 8 slides of seed 99 in non-overlapping
    windows of ``size``, the same for every seed."""
    from ..data.pap import synthetic_slide_dataset

    return synthetic_slide_dataset(seed=99, num_slides=8, slide_size=2 * size, win_size=size, overlap=0.0,
                                   is_train=False)


def lift_arms(args, train_ds):
    """[(arm, its labeled dataset, whether it runs the MT step)] in the JAX
    script's order (:246-260)."""
    arms = [("sup", train_ds, False), ("mt", train_ds, True)]
    wanted = set(args.arms.split(",")) if args.arms else set()
    # opt-in only: the ODKD baseline and the PSM-only and MGD-only arms
    arms += [(extra, train_ds, True) for extra in ("odkd", "psm", "mgd") if extra in wanted]
    if args.oracle_slides > 0:
        from ..data.pap import synthetic_slide_dataset

        oracle_ds = synthetic_slide_dataset(seed=args.seed, num_slides=args.oracle_slides, slide_size=2 * args.size,
                                            win_size=args.size, overlap=0.5)
        arms.append(("oracle", oracle_ds, False))
    if wanted:
        arms = [a for a in arms if a[0] in wanted]
    return arms


def arm_dir(args, arm: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"mt_lift_{arm}" + (f"_s{args.seed}" if args.seed else "")
                        + (f"_{args.tag}" if args.tag else ""))


def arm_loaders(args, arm_ds, unlabeled_ds, with_mt: bool, canvas: int):
    """(source loader, unlabeled loader or None) of one arm, each from the
    JAX script's seed."""
    from ..data.loader import make_source_loader, make_unlabeled_loader

    src = make_source_loader(arm_ds, args.batch, canvas, max_gt=MAX_GT, min_size=args.size, seed=args.seed)
    unl = (make_unlabeled_loader(unlabeled_ds, args.batch, canvas, min_size=args.size, seed=1 + args.seed)
           if with_mt else None)
    return src, unl


def val_loader(args, val_ds, canvas: int):
    """The held-out windows as raw uint8 canvases (the device normalizes)."""
    from ..data.loader import make_test_loader

    return make_test_loader(val_ds, args.batch, canvas, max_gt=MAX_GT, min_size=args.size, raw_u8=True)


def arm_steps(init, cfg):
    """The train step object of one arm: a copy of the shared init as the
    student, a copy of that as the teacher, and the step draws' generator."""
    from ..train import MTTrainer
    from ..train.mean_teacher import teacher_of

    gen = torch.Generator(device=next(init.parameters()).device).manual_seed(STEP_SEED)
    return MTTrainer(copy.deepcopy(init), teacher_of(init), cfg, gen)


def train_arm(steps, src, unl, out_dir: str):
    """Run the host loop of one arm to MAX_ITER, resuming from the
    directory's tag where there is one; returns the loop."""
    from ..engine.trainer import MTTrainer

    loop = MTTrainer(steps, src, unl, output_dir=out_dir)
    try:
        loop.train(loop.resume())
    finally:
        for loader in (loop.source_loader, loop.unlabeled_loader):
            close = getattr(loader, "close", None)
            if close is not None:
                close()
    return loop


def main(argv=None) -> dict:
    from ..models.detector import resolve_device
    from ..utils.checkpoint import Checkpointer, load_model_weights

    args = parse_args(argv)
    device = resolve_device(args.device)
    size = args.size
    canvas = args.canvas or size
    if canvas % 32 or canvas < size:
        raise ValueError(f"the canvas {canvas} must be a multiple of 32 and at least --size {size}")
    init, _ = build_model(canvas, with_hint=args.fg_hint > 0)
    eval_model = build_model(canvas, with_hint=False)[0].to(device)

    train_ds, unlabeled_ds, val_ds = lift_data(args)
    print(f"labeled windows: {len(train_ds)}, unlabeled patches: {len(unlabeled_ds)}, val windows: {len(val_ds)}",
          flush=True)
    init = init_model(init, args.seed).to(device)
    if args.init_from:
        # every tensor of the model must be in the save
        load_model_weights(init, load_saved_weights(args.init_from))
        print(f"initialized all arms from {args.init_from}", flush=True)

    results = {}
    t_all = time.time()
    for arm, arm_ds, with_mt in lift_arms(args, train_ds):
        out_dir = arm_dir(args, arm)
        os.makedirs(out_dir, exist_ok=True)
        steps = arm_steps(init, arm_config(args, arm))
        src, unl = arm_loaders(args, arm_ds, unlabeled_ds, with_mt, canvas)
        t0 = time.time()
        train_arm(steps, src, unl, out_dir)
        print(f"[{arm}] trained {args.iters} iters in {time.time() - t0:.0f}s", flush=True)
        # the final student and teacher, for post-hoc diagnostics
        ck = Checkpointer(out_dir)
        ck.save(f"{arm}_final_student", {"model": steps.model.state_dict()}, tag=False)
        if with_mt:
            ck.save(f"{arm}_final_teacher", {"model": steps.teacher.state_dict()}, tag=False)

        load_model_weights(eval_model, steps.model.state_dict())
        results[f"{arm}_student"] = evaluate(eval_model, val_loader(args, val_ds, canvas))
        print(f"[{arm}] student: {results[f'{arm}_student']}", flush=True)
        if with_mt:
            # LAMBDA 0 never EMAs the teacher (MTtrainer.py:195): the
            # supervised arms' teacher is the init, not worth scoring
            load_model_weights(eval_model, steps.teacher.state_dict())
            results[f"{arm}_teacher"] = evaluate(eval_model, val_loader(args, val_ds, canvas))
            print(f"[{arm}] teacher: {results[f'{arm}_teacher']}", flush=True)
        del steps

    results["meta"] = {
        "seed": args.seed,
        "size": size,
        "canvas": canvas,
        "iters": args.iters,
        "start_mt": args.start_mt,
        "lambda": args.lam,
        "alpha": args.alpha,
        "fg_hint": args.fg_hint,
        "train_ratio": args.train_ratio,
        "labeled_windows": len(train_ds),
        "unlabeled_patches": len(unlabeled_ds),
        "total_seconds": round(time.time() - t_all, 1),
    }
    if device.type == "cuda":
        from ..utils.env import card_line

        results["meta"]["card"] = card_line()
    print(json.dumps(results, indent=2))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
