"""Per-image inference and its fps, the port's root ``demo.py``.

    python -m ppyolo_tpu_torch.entry.demo --config 0 --precision int8 --image_dir images/test

Weights come from ``test_cfg['model_path']`` (an npz in the JAX package's
format, or a reference ``.pt`` through the converter; random weights from
seed 0, with a warning, when it is missing).  Ten
warm-up detections of the first image (the reference demo.py:120-123; on
the card they capture the batch-1 graph), then every jpg/png of
``--image_dir`` in name order through ``Detector.detect_image``, one image
a replay, while a reader thread (``data/loader.py::Prefetcher``) decodes
the next ones.  With ``test_cfg['draw_image']`` the detections above
``draw_thresh`` are drawn into ``--out_dir``.  ``main`` returns the image
count, fps (host clock over the loop) and, on a card, the device ms a
detection (CUDA events around each, upload and copy out included).
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint.convert import load_weights
from ..data.loader import Prefetcher
from ..eval.coco_eval import get_classes
from ..eval.detector import Detector
from ..eval.visualize import draw
from ..models import PPYOLO
from ..ops.module import resolve_device
from .train import str2bool

logger = logging.getLogger(__name__)

WARMUP = 10
IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def demo_state_dict(cfg, model) -> dict:
    """The weights of ``test_cfg['model_path']``, or seed-0 random ones."""
    model.init_parameters(torch.Generator().manual_seed(0))
    state_dict = model.state_dict()
    model_path = cfg.test_cfg.get("model_path")
    if model_path and os.path.exists(model_path):
        logger.info("loaded %s", model_path)
        return load_weights(model_path, state_dict)
    logger.warning("model file %s missing - using random init", model_path)
    return state_dict


def run_demo(cfg, image_dir: str, out_dir: str, *, precision: str = "fp32",
             device=None) -> dict:
    import cv2

    device = resolve_device(device)
    model = PPYOLO.from_config(cfg)
    state_dict = demo_state_dict(cfg, model)
    paths = sorted(p for p in glob.glob(os.path.join(image_dir, "*"))
                   if p.lower().endswith(IMAGE_EXTS))
    if not paths:
        raise FileNotFoundError(f"no images under {image_dir}")
    class_names = (get_classes(cfg.classes_path) if os.path.exists(cfg.classes_path)
                   else [str(i) for i in range(cfg.num_classes)])
    det = Detector(model, state_dict, cfg, target_size=cfg.test_cfg["target_size"],
                   precision=precision, device=device)
    drawing = bool(cfg.test_cfg.get("draw_image"))
    thresh = cfg.test_cfg["draw_thresh"] if drawing else None
    os.makedirs(out_dir, exist_ok=True)

    img = cv2.imread(paths[0])
    for _ in range(WARMUP):
        det.detect_image(img)

    def read_images():
        for path in paths:
            yield path, cv2.imread(path)

    on_card = device.type == "cuda"
    events = []
    n, t0 = 0, time.perf_counter()
    with Prefetcher(read_images(), max_batch=4) as images:
        for path, img in images:
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            boxes, scores, classes = det.detect_image(img, draw_thresh=thresh)
            if on_card:
                end.record()
                events.append((start, end))
            n += 1
            if drawing:
                draw(img, boxes, scores, classes, class_names)
                cv2.imwrite(os.path.join(out_dir, os.path.basename(path)), img)
            if n % 50 == 0:
                logger.info("%d imgs, fps=%.1f", n, n / (time.perf_counter() - t0))
    cost = time.perf_counter() - t0
    fps = n / cost
    logger.info("total %d images, cost %.2fs, fps=%.1f", n, cost, fps)
    device_ms = None
    if on_card:
        torch.cuda.synchronize(device)
        device_ms = float(np.mean([s.elapsed_time(e) for s, e in events]))
    return {"images": n, "seconds": cost, "fps": fps, "device_ms": device_ms,
            "precision": precision, "device": str(device), "drawn": n if drawing else 0}


def main(argv: Optional[list] = None) -> dict:
    from configs import get_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--use_gpu", type=str2bool, default=True, help="False runs on the host CPU")
    p.add_argument("--precision", type=str, default="fp32", choices=["fp32", "bf16", "int8"])
    p.add_argument("--image_dir", type=str, default="images/test")
    p.add_argument("--out_dir", type=str, default="images/res")
    args = p.parse_args(argv)
    return run_demo(get_config(args.config), args.image_dir, args.out_dir,
                    precision=args.precision, device=None if args.use_gpu else "cpu")


if __name__ == "__main__":
    from ..utils.logger import setup_logger

    setup_logger()
    main()
