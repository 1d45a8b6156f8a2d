"""COCO val mAP evaluation entry point of the port (the root ``eval.py``).

    python -m ppyolo_tpu_torch.entry.eval --config 0 --precision bf16

``--precision int8`` serves the int8 form (quantized convs on K5, dynamic
activation scales; ``eval/optimize.py``).  Weights come from
``eval_cfg['model_path']`` (an npz in the JAX package's format; random
weights from seed 0 when it is missing) or the caller's ``state_dict``.
``type_='test_dev'`` writes the submission json of ``cfg.test_path``
instead (``entry/test_dev.py``).  ``--scan_group N`` runs N batches as one
unit of work (``Detector.predict_pipelined``).  On N cards, one process each:

    python -m torch.distributed.run --nproc_per_node N -m ppyolo_tpu_torch.entry.eval --config 0

every rank evaluates its shard of the images on its own card and rank 0
merges the shards and scores them (``coco_eval(distributed=True)``; the
others return None).  ``--ndev`` must equal the world size.  A
reference ``.pt`` ``model_path`` loads through the converter
(``checkpoint/convert.py``).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import torch

from ..checkpoint.convert import load_weights
from ..data.coco import CocoJson
from ..eval.coco_eval import clsid_to_catid, coco_eval, get_classes
from ..eval.detector import Detector
from ..models import PPYOLO
from ..parallel import dist
from .train import check_ndev, str2bool

logger = logging.getLogger(__name__)


def run_eval(cfg, *, type_: str = "eval", state_dict=None, precision: str = "fp32",
             device=None, result_dir: str = "eval_results", ndev: Optional[int] = None,
             scan_group: int = 1):
    """The 12 box-AP stats of ``cfg``'s val set (None for test-dev, and on
    every rank but 0 under a process group).  ``device`` defaults to
    ``cuda`` (the rank's card under a group) and raises without a card;
    ``ndev`` defaults to the world size."""
    check_ndev(ndev)
    model = PPYOLO.from_config(cfg)
    if state_dict is None:
        model.init_parameters(torch.Generator().manual_seed(0))
        state_dict = model.state_dict()
        model_path = cfg.eval_cfg.get("model_path")
        if model_path and os.path.exists(model_path):
            state_dict = load_weights(model_path, state_dict)
            logger.info("loaded %s", model_path)
        else:
            logger.warning("model file %s missing - using random init", model_path)
    test_dev = type_ == "test_dev"
    anno_path = cfg.test_path if test_dev else cfg.val_path
    pre_path = cfg.test_pre_path if test_dev else cfg.val_pre_path
    coco = CocoJson(anno_path)
    images = list(coco.dataset["images"])
    if type_ == "eval":   # only images with gt (reference eval.py:66-72)
        images = [im for im in images if coco.img_anns.get(im["id"])]
    det = Detector(model, state_dict, cfg, target_size=cfg.eval_cfg["target_size"],
                   precision=precision, device=device)
    class_names = get_classes(cfg.classes_path) if os.path.exists(cfg.classes_path) else None
    stats = coco_eval(det, images, pre_path, anno_path, cfg.eval_cfg["eval_batch_size"],
                      type_=type_, result_dir=result_dir, clsid2catid=clsid_to_catid(cfg, coco),
                      draw_image=cfg.eval_cfg.get("draw_image", False),
                      draw_thresh=cfg.eval_cfg.get("draw_thresh", 0.15),
                      class_names=class_names, scan_group=scan_group,
                      distributed=dist.active())
    if stats is not None:
        logger.info("box ap: %.4f", float(stats[0]))
    return stats


def main(argv: Optional[list] = None, type_: str = "eval"):
    from configs import get_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--use_gpu", type=str2bool, default=True, help="False runs on the host CPU")
    p.add_argument("--precision", type=str, default="fp32", choices=["fp32", "bf16", "int8"])
    p.add_argument("--ndev", type=int, default=None,
                   help="cards, one process each (default: the world size)")
    p.add_argument("--scan_group", type=int, default=1,
                   help=">1 runs that many batches as one unit (one CUDA graph replay)")
    p.add_argument("--result_dir", type=str, default="eval_results")
    args = p.parse_args(argv)
    with dist.env_group(None if args.use_gpu else "cpu") as device:
        return run_eval(get_config(args.config), type_=type_, precision=args.precision,
                        device=device, result_dir=args.result_dir, ndev=args.ndev,
                        scan_group=args.scan_group)


if __name__ == "__main__":
    from ..utils.logger import setup_logger

    setup_logger()
    main()
