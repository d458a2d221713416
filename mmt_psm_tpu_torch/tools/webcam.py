"""Webcam demo: camera frames through ``CellDemo`` (the port's copy of
``tools/webcam.py``, after the reference's demo/webcam.py:1-82: cv2
capture, run_on_opencv_image, imshow).

    python -m mmt_psm_tpu_torch.tools.webcam --ckpt RUN/model_final.pth [--config-file YAML]
        [--camera 0] [--min-image-size 256] [--confidence-threshold 0.5] [--device cpu] [KEY VALUE ...]

OpenCV gives BGR frames and ``CellDemo`` takes RGB, so each frame is
flipped on the way in and out. ESC or the end of the stream stops it.
The config defaults to the flagship's; ``--ckpt`` is a ``.pth`` written by
``utils/checkpoint.py::Checkpointer`` (the weights under ``"model"``). It
runs on the card unless ``--device`` names another device. Needs OpenCV
(``cv2``).
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="webcam demo")
    parser.add_argument("--config-file", default=None, type=str, help="default: the flagship's YAML")
    parser.add_argument("--ckpt", required=True, type=str, help="a Checkpointer .pth")
    parser.add_argument("--camera", default=0, type=int)
    parser.add_argument("--min-image-size", default=256, type=int)
    parser.add_argument("--confidence-threshold", default=0.5, type=float)
    parser.add_argument("--device", default=None, type=str, help="torch device; default: the card")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    """Show overlays until ESC or the stream ends; returns the frames shown."""
    args = parse_args(argv)
    import cv2

    from ..engine.predictor import CellDemo
    from ..models.detector import FLAGSHIP_CONFIG, load_config, model_from_cfg, resolve_device
    from ..utils.checkpoint import Checkpointer, load_model_weights

    cfg = load_config(args.config_file or FLAGSHIP_CONFIG, args.opts or ())
    model = model_from_cfg(cfg, resolve_device(args.device))
    ckpt_dir, name = os.path.split(args.ckpt)
    load_model_weights(model, Checkpointer(ckpt_dir or ".").load(name[: -len(".pth")] if name.endswith(".pth")
                                                                 else name)["model"])
    demo = CellDemo(model, min_size=args.min_image_size, confidence_threshold=args.confidence_threshold)

    cam = cv2.VideoCapture(args.camera)
    if not cam.isOpened():
        raise SystemExit(f"cannot open camera {args.camera}")
    frames = 0
    try:
        while True:
            start = time.time()
            ret, frame_bgr = cam.read()
            if not ret:
                break
            overlay_rgb = demo.run_on_image(frame_bgr[..., ::-1])
            print(f"{time.time() - start:.3f} s/frame", flush=True)
            cv2.imshow("mmt_psm_tpu_torch", overlay_rgb[..., ::-1])
            frames += 1
            if cv2.waitKey(1) == 27:  # ESC
                break
    finally:
        cam.release()
        cv2.destroyAllWindows()
    return frames


if __name__ == "__main__":
    main()
