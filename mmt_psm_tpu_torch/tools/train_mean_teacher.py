"""Mean-teacher training (the port's copy of ``tools/train_mean_teacher.py``,
after the reference's tools/train_mean_teacher.py:104-204).

    python -m mmt_psm_tpu_torch.tools.train_mean_teacher [--config-file YAML] [--synthetic] [--resume]
        [--weights F] [--skip-test] [--output-dir D] [--device cpu] [KEY VALUE ...]

Builds the student of the config (default: the flagship's,
``configs/pap/mmt_psm_r50_fpn.yaml``) with seeded random weights, its EMA
teacher and the training loaders, and runs ``engine/trainer.py::MTTrainer``
into the output directory (``config.yaml``, ``log.txt``, ``model_*.pth``,
``t_model_*.pth``, ``last_checkpoint``). ``--synthetic`` trains on
synthetic slides made from the JAX CLI's seeds, else the catalog resolves
DATASETS.TRAIN and, with DATASETS.NO_LABEL, DATASETS.GEN. ``--weights``
loads a ``.pth`` or Caffe2 ``.pkl`` in transfer mode into the student
before the teacher is copied from it. A tag in the output directory wins
over ``--weights``: the run resumes from it (``--resume`` says so
explicitly). A resumed run restarts the loaders from their seeds, as the
JAX CLI does, so it sees the first batches again. After training, unless
``--skip-test``, a test-time model takes the student's weights and
``run_inference`` scores it on the val split; ``final_eval.json`` holds the
JAX CLI's keys. Runs on the card unless ``--device`` names another device.

Data parallelism: ``torchrun --nproc_per_node W -m
mmt_psm_tpu_torch.tools.train_mean_teacher ...`` (WORLD_SIZE > 1) runs one
rank a card, each on ``cuda:LOCAL_RANK`` (``--device``, where given, must
name that card, or the CPU over gloo). Each step is the single-process step
on the global batch of SOLVER.IMS_PER_BATCH images
(``engine/trainer.py``); rank 0 writes ``config.yaml``, the log, the
checkpoints and ``final_eval.json``, and the val sweep is sharded over the
ranks (``engine/inference.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MMT-PSM mean-teacher training")
    parser.add_argument("--config-file", default=None, type=str, help="default: the flagship's YAML")
    parser.add_argument("--synthetic", action="store_true", help="train on synthetic slides")
    parser.add_argument("--weights", default="", type=str, help=".pth or Caffe2 .pkl init (transfer mode)")
    parser.add_argument("--resume", action="store_true", help="resume from last_checkpoint in the output dir")
    parser.add_argument("--skip-test", action="store_true", help="skip the val sweep after training")
    parser.add_argument("--output-dir", default="runs/mt", type=str)
    parser.add_argument("--device", default=None, type=str, help="torch device; default: the card")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def build_data(cfg, synthetic: bool, canvas: int):
    """(source dataset, unlabeled dataset or None, MIN_SIZE) of the run."""
    from ..data.pap import PapUnlabeledDataset, synthetic_slide_dataset

    if synthetic:
        # the JAX CLI's slides and seeds (tools/train_mean_teacher.py:56-65)
        win = min(canvas, 256)
        source = synthetic_slide_dataset(seed=0, num_slides=4, slide_size=2 * win, win_size=win, overlap=0.5)
        patches = [synthetic_slide_dataset(seed=10 + i, num_slides=1, slide_size=win, win_size=win).slides[0]
                   for i in range(8)]
        return source, PapUnlabeledDataset(patches), win
    from ..data.catalog import DatasetCatalog, build_datasets

    if not cfg.DATASETS.TRAIN:
        raise SystemExit(f"cfg.DATASETS.TRAIN is empty: name catalog datasets (known: "
                         f"{sorted(DatasetCatalog.DATASETS)}) or pass --synthetic.")
    unlabeled = build_datasets(cfg.DATASETS.GEN) if cfg.DATASETS.NO_LABEL else None
    # resized images must fit the canvas (pad_to_canvas checks h, w <= canvas)
    return build_datasets(cfg.DATASETS.TRAIN), unlabeled, min(int(cfg.INPUT.MIN_SIZE_TRAIN), canvas)


def main(argv=None) -> dict:
    """Train, then score; returns {"trainer": the loop, "start_iter": where
    it began, "final_eval": the val summary or None}."""
    from ..data.loader import make_source_loader, make_unlabeled_loader
    from ..engine.trainer import MTTrainer
    from ..models.detector import FLAGSHIP_CONFIG
    from ..parallel import comm
    from ..train import build_mt_trainer

    args = parse_args(argv)
    device = comm.launch_device(args.device)
    steps = build_mt_trainer(args.config_file or FLAGSHIP_CONFIG, device=device, seed=0, opts=args.opts)
    cfg = steps.cfg
    canvas = steps.model.config.image_size
    source_ds, unlabeled_ds, min_size = build_data(cfg, args.synthetic, canvas)
    batch = int(cfg.SOLVER.IMS_PER_BATCH)
    src_loader = make_source_loader(source_ds, batch, canvas, max_gt=cfg.TPU.MAX_GT, min_size=min_size,
                                    max_size=canvas)
    unl_loader = (make_unlabeled_loader(unlabeled_ds, batch, canvas, aug_k=cfg.MT.AUG_K, aug_s=cfg.MT.AUG_S,
                                        min_size=min_size, max_size=canvas)
                  if cfg.DATASETS.NO_LABEL and unlabeled_ds is not None else None)

    if args.weights:
        from ..utils.c2_loading import load_checkpoint_file

        arch = "R-101" if "101" in cfg.MODEL.BACKBONE.CONV_BODY else "R-50"
        report = load_checkpoint_file(args.weights, steps.model, transfer=True, arch=arch)
        # the teacher starts as a copy of the initialised student (JAX copies
        # it from the loaded params, engine/trainer.py:77)
        steps.teacher.load_state_dict(steps.model.state_dict())
        if comm.is_main_process():
            print(f"loaded {len(report['loaded'])} tensors from {args.weights}; missing {len(report['missing'])}, "
                  f"mismatched {len(report['mismatched'])}", flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    if comm.is_main_process():
        with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
            f.write(cfg.dump())

    trainer = MTTrainer(steps, src_loader, unl_loader, output_dir=args.output_dir)
    # a tag in the run dir wins over the init weights (reference
    # utils/checkpoint.py:82-99); --resume is an explicit alias
    start_iter = trainer.resume() if (args.resume or trainer.ckpt.has_checkpoint()) else 0
    try:
        trainer.train(start_iter)
    finally:
        for loader in (trainer.source_loader, trainer.unlabeled_loader):
            close = getattr(loader, "close", None)
            if close is not None:
                close()
    summary = None if args.skip_test else final_eval(cfg, steps.model, args, canvas, min_size, device)
    return {"trainer": trainer, "start_iter": start_iter, "final_eval": summary}


def final_eval(cfg, student, args, canvas: int, min_size: int, device):
    """The val sweep after training (JAX tools/train_mean_teacher.py:
    129-166): a test-time model with the student's weights scored by
    ``run_inference``; writes and returns ``final_eval.json``'s summary."""
    from ..data.loader import make_test_loader
    from ..data.pap import synthetic_slide_dataset
    from ..data.samplers import ShardSampler
    from ..engine.inference import run_inference
    from ..models.detector import model_from_cfg
    from ..parallel import comm
    from ..utils.checkpoint import load_model_weights

    if args.synthetic:
        win = min(canvas, 256)
        val_ds = synthetic_slide_dataset(seed=42, num_slides=2, slide_size=2 * win, win_size=win, overlap=0.0,
                                         is_train=False)
    elif cfg.DATASETS.VAL:
        from ..data.catalog import build_datasets

        val_ds = build_datasets(cfg.DATASETS.VAL)
    else:
        return None
    model = model_from_cfg(cfg, device)
    load_model_weights(model, student.state_dict())
    world = comm.get_world_size()
    loader = make_test_loader(val_ds, cfg.TEST.IMS_PER_BATCH, canvas, max_gt=cfg.TPU.MAX_GT, min_size=min_size,
                              max_size=canvas, raw_u8=True,
                              indices=ShardSampler(len(val_ds), world, comm.get_rank(), shuffle=False)
                              if world > 1 else None)
    stats, timing = run_inference(model, loader, eval_workers=int(cfg.TEST.EVAL_WORKERS),
                                  prefetch_depth=int(cfg.DATALOADER.PREFETCH_DEPTH))
    aji = {str(k): v for k, v in stats["AJI"].items()}
    summary = {
        "AJI": aji,
        "AJI_mean": float(np.mean(list(aji.values()))) if aji else 0.0,
        "mAP": stats["mAP"].get("all", -1),
        "AP50": stats["AP50"].get("all", -1),
        "images_per_sec": timing["images_per_sec"],
    }
    if comm.is_main_process():
        with open(os.path.join(args.output_dir, "final_eval.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print("final_eval:", json.dumps(summary), flush=True)
    comm.synchronize()
    return summary


if __name__ == "__main__":
    main()
