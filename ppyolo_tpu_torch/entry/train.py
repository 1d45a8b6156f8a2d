"""PP-YOLO training entry point of the port (the root ``train.py``).

    python -m ppyolo_tpu_torch.entry.train --config 0 --precision bf16

follows ``train.py:57-370`` on one card: weights from
``train_cfg['model_path']`` (an npz in the JAX package's format; a
'step%08d' name also sets the resume step), a full train state from
``train_cfg['resume_state']``, the start iter the later of the two; the
COCO records cleaned and streamed by ``train_batches`` on a background
thread, staged to the card by the pinned ``DevicePrefetcher``; the LR and
the data stream both restart from the restored step, so a resumed run
steps as the uninterrupted one would.  Every ``log_iter`` steps a row of
losses goes to ``weights_dir/metrics.jsonl``; every ``save_iter`` steps
the EMA-applied params go to ``step%08d.npz`` and the full state to
``last_state.npz``, written on a thread while the steps go on (the newest
10 finished step files kept, beside the one being written); every ``eval_iter``
steps a COCO eval on ``cfg.val_path`` (the best AP's params in
``best_model.npz``).  The eval runs at the training precision, on an eval
model of its own that ``Detector.set_params`` refreshes.

Not ported, and refused with ``NotImplementedError``: several cards or
processes (``ndev > 1``), ``scan_steps > 1``, the orbax checkpoint
backend, ``warmup_shapes`` and ``.pt`` weights.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import torch

from ..checkpoint.io import (AsyncCheckpointer, gc_checkpoints, load_params_npz,
                             load_train_state, resume_step_from_filename)
from ..data.coco import CocoJson, category_maps, data_clean
from ..data.loader import DevicePrefetcher, Prefetcher, train_batches
from ..eval.coco_eval import clsid_to_catid, coco_eval
from ..eval.detector import Detector
from ..models import PPYOLO
from ..ops.ema import ema_apply
from ..ops.module import resolve_device
from ..train.loop import PRECISIONS, step_loop
from ..train.train_step import TrainState, init_train_state, make_train_step

logger = logging.getLogger(__name__)


def str2bool(v) -> bool:
    """argparse type for yes/no flags (the repository's ``tools/argparser``)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Unsupported value encountered.")


def check_ported(cfg, ndev: int = 1) -> None:
    """Raise for the training inputs this port does not run."""
    tc = cfg.train_cfg
    if ndev > 1:
        raise NotImplementedError("training on several cards is not ported (ROADMAP §1 item 8)")
    if int(tc.get("scan_steps", 1)) > 1:
        raise NotImplementedError("scan_steps > 1 is not ported (ROADMAP §1 item 6)")
    if tc.get("ckpt_backend", "npz") != "npz":
        raise NotImplementedError(f"checkpoint backend {tc['ckpt_backend']!r} is not ported "
                                  "(ROADMAP §1 item 8)")
    if tc.get("warmup_shapes"):
        raise NotImplementedError("warmup_shapes is not ported (ROADMAP §1 item 4)")
    if str(tc.get("model_path") or "").endswith(".pt"):
        raise NotImplementedError(".pt weights are not ported (ROADMAP §1 item 12)")


def eval_state_dict(state: TrainState):
    """The params one evaluates or saves: the EMA shadow over the live state."""
    sd = state.model.state_dict()
    return ema_apply(sd, state.ema) if state.ema is not None else dict(sd)


def run_training(cfg, *, weights_dir: str = "./weights", device=None,
                 ndev: int = 1) -> TrainState:
    """Train ``cfg`` on its COCO train set and return the final state.
    ``device`` defaults to ``cuda`` and raises without a card."""
    check_ported(cfg, ndev)
    dev = resolve_device(device)
    tc = cfg.train_cfg
    precision = tc.get("precision", "fp32")

    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    start_iter = 0
    model_path = tc.get("model_path")
    if model_path and os.path.exists(model_path):
        model.load_state_dict(load_params_npz(model_path, model.state_dict()))
        start_iter = resume_step_from_filename(model_path) or 0
        logger.info("loaded %s (resume iter %d)", model_path, start_iter)
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    state.step = start_iter
    resume_state = tc.get("resume_state")
    if resume_state and os.path.exists(resume_state):
        load_train_state(resume_state, state)
        logger.info("resumed full train state from %s (step %d)", resume_state, state.step)
    # the data stream and the LR restart from the restored step
    start_iter = max(start_iter, state.step)
    state.step = start_iter
    os.makedirs(weights_dir, exist_ok=True)

    coco = CocoJson(cfg.train_path)
    catid2clsid, _, _ = category_maps(coco)
    records = data_clean(coco, coco.get_img_ids(), catid2clsid, cfg.train_pre_path)
    logger.info("%d samples in train set.", len(records))

    step_fn = make_train_step(model, cfg, compute_dtype=PRECISIONS[precision])
    generator = torch.Generator(device=dev).manual_seed(1)
    metrics_path = os.path.join(weights_dir, "metrics.jsonl")
    ckpt = AsyncCheckpointer()
    eval_det, best_ap = None, -1.0   # one eval model, refreshed by set_params

    def log_row(row):
        with open(metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def on_log(it, losses, info):
        log_row({"iter": it, "time": time.time(), **losses, "size": info["size"],
                 "step_s": info["step_s"], "imgs_per_sec": info["imgs_per_sec"],
                 "tflops": None, "mfu": None})   # utils/mfu is not ported

    def after_step(st: TrainState):
        nonlocal eval_det, best_ap
        it = st.step
        if it % tc["save_iter"] == 0:
            # joins the previous write, so GC sees every earlier file finished
            # and skips this one's temporary
            ckpt.save_step(os.path.join(weights_dir, f"step{it:08d}.npz"), eval_state_dict(st),
                           os.path.join(weights_dir, "last_state.npz"), st)
            gc_checkpoints(weights_dir, keep=10)
            logger.info("saved %s/step%08d.npz", weights_dir, it)
        if it % tc["eval_iter"] == 0 and os.path.exists(cfg.val_path):
            t0 = time.time()
            params = eval_state_dict(st)
            if eval_det is None:
                eval_det = Detector(PPYOLO.from_config(cfg), params, cfg,
                                    target_size=cfg.eval_cfg["target_size"],
                                    precision=precision, device=dev)
            else:
                eval_det.set_params(params)
            val = CocoJson(cfg.val_path)
            images = [im for im in val.dataset["images"] if val.img_anns.get(im["id"])]
            stats = coco_eval(eval_det, images, cfg.val_pre_path, cfg.val_path,
                              cfg.eval_cfg["eval_batch_size"],
                              result_dir=os.path.join(weights_dir, "eval_results"),
                              clsid2catid=clsid_to_catid(cfg, val))
            ap = float(stats[0])
            logger.info("box ap: %.4f (best %.4f)", ap, best_ap)
            log_row({"iter": it, "time": time.time(), "box_ap": ap,
                     "stats": [float(s) for s in stats], "images": len(images),
                     "eval_s": time.time() - t0})
            if ap > best_ap:
                best_ap = ap
                ckpt.save_params(os.path.join(weights_dir, "best_model.npz"), params)

    host = Prefetcher(train_batches(records, cfg, seed=0, start_iter=start_iter),
                      max_batch=tc.get("max_batch", 3))
    try:
        state = step_loop(state, step_fn, DevicePrefetcher(host, dev), generator,
                          max_iters=int(tc["max_iters"]), log_every=int(tc.get("log_iter", 20)),
                          on_log=on_log, after_step=after_step)
    finally:
        host.close()
        ckpt.wait()
    gc_checkpoints(weights_dir, keep=10)
    logger.info("done at iter %d", state.step)
    return state


def main(argv: Optional[list] = None) -> TrainState:
    from configs import get_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--use_gpu", type=str2bool, default=True,
                   help="False runs on the host CPU")
    p.add_argument("--ndev", type=int, default=1, help="cards (only 1 is ported)")
    p.add_argument("--precision", type=str, default="fp32", choices=["fp32", "bf16"],
                   help="bf16 = mixed-precision forward (fp32 masters)")
    p.add_argument("--scan_steps", type=int, default=1, help="only 1 is ported")
    p.add_argument("--weights_dir", type=str, default="./weights")
    args = p.parse_args(argv)
    cfg = get_config(args.config)
    cfg.train_cfg["precision"] = args.precision
    cfg.train_cfg["scan_steps"] = args.scan_steps
    return run_training(cfg, weights_dir=args.weights_dir, ndev=args.ndev,
                        device=None if args.use_gpu else "cpu")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s-%(levelname)s: %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    main()
