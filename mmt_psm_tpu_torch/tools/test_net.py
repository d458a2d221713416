"""Evaluation sweep over checkpoints (the port's copy of ``tools/test_net.py``,
after the reference's tools/test_net.py:24-303).

    python -m mmt_psm_tpu_torch.tools.test_net --ckpt-dir DIR [--config-file YAML] [--synthetic]
        [--output-dir OUT] [--device cpu] [KEY VALUE ...]

Evaluates every ``model_*.pth`` and ``t_model_*.pth`` checkpoint of DIR,
in name order, on the val/test split (``--synthetic``: 8 windows of 256
px from two synthetic slides), and writes ``result.json`` and
``best_result.json`` (AJI per class and its mean, mAP, AP50/75/85, F1 per
class, images/s per checkpoint), and ``metrics.png`` where matplotlib
imports. The config defaults to the flagship's
(``configs/pap/mmt_psm_r50_fpn.yaml``). It runs on the card unless
``--device`` names another device.

Under ``torchrun --nproc_per_node W -m mmt_psm_tpu_torch.tools.test_net ...``
(WORLD_SIZE > 1) each rank joins the process group on ``cuda:LOCAL_RANK``
(``--device``, where given, must name that card, or the CPU over gloo),
scores its shard of the windows, and every rank gets the whole split's
stats (``engine/inference.py``); rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Papeval sweep over checkpoints")
    parser.add_argument("--config-file", default=None, type=str, help="default: the flagship's YAML")
    parser.add_argument("--ckpt-dir", required=True, type=str)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--output-dir", default="", type=str)
    parser.add_argument("--device", default=None, type=str, help="torch device; default: the card")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    from ..config import get_cfg
    from ..data.loader import make_test_loader
    from ..data.pap import synthetic_slide_dataset
    from ..data.transforms import PIXEL_MEAN_BGR
    from ..engine.inference import check_expected_results, run_inference
    from ..data.samplers import ShardSampler
    from ..models.detector import FLAGSHIP_CONFIG, model_from_cfg
    from ..parallel import comm
    from ..utils.checkpoint import Checkpointer, load_model_weights

    args = parse_args(argv)
    device = comm.launch_device(args.device)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file or FLAGSHIP_CONFIG)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if list(cfg.INPUT.PIXEL_STD) != [1.0, 1.0, 1.0]:
        raise NotImplementedError("the device stage subtracts the pixel mean only: INPUT.PIXEL_STD must be 1")
    if not np.array_equal(np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32), PIXEL_MEAN_BGR):
        raise NotImplementedError(f"the device stage subtracts the constant mean {PIXEL_MEAN_BGR.tolist()}: "
                                  f"INPUT.PIXEL_MEAN must equal it")

    model = model_from_cfg(cfg, device)
    canvas = model.config.image_size
    if args.synthetic:
        win = min(canvas, 256)
        ds = synthetic_slide_dataset(seed=42, num_slides=2, slide_size=2 * win, win_size=win, overlap=0.0,
                                     is_train=False)
        min_size = win
    else:
        # MODE_IN_TEST picks val or test (reference tools/test_net.py:257)
        from ..data.catalog import DatasetCatalog, build_datasets

        names = cfg.DATASETS.VAL if cfg.DATASETS.MODE_IN_TEST == "val" else cfg.DATASETS.TEST
        if not names:
            raise SystemExit(f"cfg.DATASETS.{cfg.DATASETS.MODE_IN_TEST.upper()} is empty: name catalog datasets "
                             f"(known: {sorted(DatasetCatalog.DATASETS)}) or pass --synthetic.")
        ds = build_datasets(names)
        min_size = min(cfg.INPUT.MIN_SIZE_TEST, canvas)

    ckpt = Checkpointer(args.ckpt_dir)
    names = ckpt.names()
    if not names:
        raise SystemExit(f"no checkpoints in {args.ckpt_dir}")
    out_dir = args.output_dir or args.ckpt_dir
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for name in names:
        load_model_weights(model, ckpt.load(name)["model"])
        shard = ShardSampler(len(ds), comm.get_world_size(), comm.get_rank(), shuffle=False)
        loader = make_test_loader(ds, cfg.TEST.IMS_PER_BATCH, canvas, max_gt=cfg.TPU.MAX_GT, min_size=min_size,
                                  max_size=canvas, raw_u8=True,
                                  indices=shard if comm.get_world_size() > 1 else None)
        stats, timing = run_inference(
            model, loader, eval_workers=int(cfg.TEST.EVAL_WORKERS), prefetch_depth=int(cfg.DATALOADER.PREFETCH_DEPTH),
            visual_num=cfg.TEST.VISUAL_NUM,
            visual_dir=os.path.join(out_dir, f"vis_{name}") if cfg.TEST.VISUAL_NUM else None,
            mat_dir=os.path.join(out_dir, f"mat_{name}") if cfg.TEST.GEN else None,
        )
        if cfg.TEST.EXPECTED_RESULTS:
            check_expected_results(stats, cfg.TEST.EXPECTED_RESULTS, cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL)
        results[name] = summary(stats, timing)
        if comm.is_main_process():
            print(name, json.dumps(results[name]), flush=True)

    best = max(results, key=lambda n: results[n]["AJI_mean"])
    if comm.is_main_process():
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(out_dir, "best_result.json"), "w") as f:
            json.dump({best: results[best]}, f, indent=2)
        plot_metric_curves(results, out_dir)
        print("best:", best, results[best]["AJI_mean"], flush=True)
    comm.synchronize()
    return results


def summary(stats: dict, timing: dict) -> dict:
    """One checkpoint's row of ``result.json`` (the JAX CLI's keys)."""
    aji = stats["AJI"]
    return {
        "AJI": {str(k): v for k, v in aji.items()},
        "AJI_mean": float(np.mean(list(aji.values()))) if aji else 0.0,
        "mAP": stats["mAP"].get("all", -1),
        "AP50": stats["AP50"].get("all", -1),
        "AP75": stats["AP75"].get("all", -1),
        "AP85": stats["AP85"].get("all", -1),
        "F1": {str(k): v for k, v in stats["F1"].items()},
        "images_per_sec": timing["images_per_sec"],
    }


def plot_metric_curves(results: dict, out_dir: str):
    """AJI/mAP/AP curves over the checkpoint sweep, student and teacher
    series (reference tools/test_net.py:151-233); nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    series = {
        "student": sorted(n for n in results if not n.startswith("t_model")),
        "teacher": sorted(n for n in results if n.startswith("t_model")),
    }
    metrics = ["AJI_mean", "mAP", "AP50", "AP75", "AP85"]
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 3.5))
    for ax, metric in zip(axes, metrics):
        for label, names in series.items():
            if names:
                ax.plot(range(len(names)), [results[n][metric] for n in names], marker="o", label=label)
        ax.set_title(metric)
        ax.set_xlabel("checkpoint")
        ax.grid(True, alpha=0.3)
    axes[0].legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "metrics.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print("metric curves:", path, flush=True)


if __name__ == "__main__":
    main()
