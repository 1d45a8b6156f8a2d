"""PP-YOLO training entry point of the port (the root ``train.py``).

    python -m ppyolo_tpu_torch.entry.train --config 0 --precision bf16

follows ``train.py:57-370``: weights from
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

``train_cfg['scan_steps']`` batches of one size make a unit of work
(``make_multi_train_step``); on a card every unit is one replay of a CUDA
graph, captured at the first unit of each size, or for every size before
the loop with ``train_cfg['warmup_shapes']`` (one ``{"warmup_size", "secs",
"time"}`` line per size in metrics.jsonl).  Checkpoints and evals fall on
the units that cross their cadence, as in ``train.py``.

On N cards, one process each (``parallel/dist.py``):

    python -m torch.distributed.run --nproc_per_node N \
        -m ppyolo_tpu_torch.entry.train --config 0 --scan_steps 4

Each rank reads its own shard of the records and steps on ``batch_size``
images, so the global batch is ``N × batch_size``; gradients and losses
are averaged over the ranks inside each unit (a replay includes its NCCL
all-reduces), and ``norm_type='sync_bn'`` averages the BN statistics.  The
state is broadcast from rank 0 after the weights, the resume state and a
DCP restore are loaded.  Rank 0 alone writes the npz files, the GC and
``metrics.jsonl`` and runs the periodic eval (``distributed=False``); the
other ranks wait for it in the next unit's collective
(``dist.GROUP_TIMEOUT``).  ``ckpt_backend='orbax'`` adds full-state
checkpoints through ``torch.distributed.checkpoint``
(``checkpoint/dcp_io.py``, ``weights_dir/dcp``), saved by every rank and
restored from the latest step at start.  ``--use_gpu false`` runs the
ranks on the CPU under gloo; ``--ndev`` must equal the world size.
A reference ``.pt`` ``model_path`` loads through the converter
(``checkpoint/convert.py``).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import torch

from ..checkpoint.dcp_io import DCPCheckpointer
from ..checkpoint.convert import load_weights
from ..checkpoint.io import (AsyncCheckpointer, gc_checkpoints, load_train_state,
                             resume_step_from_filename)
from ..data.coco import CocoJson, category_maps, data_clean
from ..data.loader import DevicePrefetcher, Prefetcher, stack_units, train_batches
from ..eval.coco_eval import clsid_to_catid, coco_eval
from ..eval.detector import Detector
from ..models import PPYOLO
from ..ops.ema import ema_apply
from ..ops.module import resolve_device
from ..parallel import dist
from ..tools.warmup_shapes import warmup_units
from ..train.loop import PRECISIONS, make_unit_step, step_loop
from ..train.train_step import TrainState, init_train_state

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


CKPT_BACKENDS = ("npz", "orbax")


def check_ndev(ndev: Optional[int]) -> None:
    """``--ndev`` (None: the world size) must be the process group's world
    size: one process per card."""
    if ndev is not None and ndev != dist.world():
        raise ValueError(f"--ndev {ndev} differs from the world size {dist.world()}: launch "
                         f"one process per card (python -m torch.distributed.run "
                         f"--nproc_per_node {ndev} ...)")


def check_ported(cfg, ndev: Optional[int] = None) -> None:
    """Raise for the training inputs this port does not run."""
    tc = cfg.train_cfg
    check_ndev(ndev)
    if tc.get("ckpt_backend", "npz") not in CKPT_BACKENDS:
        raise ValueError(f"checkpoint backend {tc['ckpt_backend']!r} not in {CKPT_BACKENDS}")


def eval_state_dict(state: TrainState):
    """The params one evaluates or saves: the EMA shadow over the live state."""
    sd = state.model.state_dict()
    return ema_apply(sd, state.ema) if state.ema is not None else dict(sd)


def run_training(cfg, *, weights_dir: str = "./weights", device=None,
                 ndev: Optional[int] = None) -> TrainState:
    """Train ``cfg`` on its COCO train set and return the final state.
    ``device`` defaults to ``cuda`` (the rank's card under a process group)
    and raises without a card; ``ndev`` defaults to the world size."""
    check_ported(cfg, ndev)
    dev = resolve_device(device)
    tc = cfg.train_cfg
    precision = tc.get("precision", "fp32")
    is_main = dist.rank() == 0

    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    start_iter = 0
    model_path = tc.get("model_path")
    if model_path and os.path.exists(model_path):
        model.load_state_dict(load_weights(model_path, model.state_dict()))
        start_iter = resume_step_from_filename(model_path) or 0
        logger.info("loaded %s (resume iter %d)", model_path, start_iter)
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    state.set_step(start_iter)
    resume_state = tc.get("resume_state")
    if resume_state and os.path.exists(resume_state):
        load_train_state(resume_state, state)
        logger.info("resumed full train state from %s (step %d)", resume_state, state.step)
    os.makedirs(weights_dir, exist_ok=True)
    dcp_ckpt = None
    if tc.get("ckpt_backend", "npz") == "orbax":
        dcp_ckpt = DCPCheckpointer(os.path.join(weights_dir, "dcp"), keep=10)
        if dcp_ckpt.latest_step() is not None:
            dcp_ckpt.restore(state)
            logger.info("DCP resume from step %d", state.step)
    # every rank loaded the same files; rank 0's state is the replicas' start
    dist.broadcast_state(state)
    # the data stream and the LR restart from the restored step
    start_iter = max(start_iter, state.step)
    state.set_step(start_iter)

    coco = CocoJson(cfg.train_path)
    catid2clsid, _, _ = category_maps(coco)
    records = data_clean(coco, coco.get_img_ids(), catid2clsid, cfg.train_pre_path)
    logger.info("%d samples in train set.", len(records))
    if dist.world() > 1:
        logger.info("rank %d/%d reads a %d-record shard", dist.rank(), dist.world(),
                    len(records[dist.rank()::dist.world()]))

    scan_steps = int(tc.get("scan_steps", 1))
    generator = torch.Generator(device=dev).manual_seed(1)   # alike on every rank
    unit_step = make_unit_step(model, cfg, state, generator, n_steps=scan_steps,
                               compute_dtype=PRECISIONS[precision],
                               capture=dist.can_capture(dev))
    metrics_path = os.path.join(weights_dir, "metrics.jsonl")
    ckpt = AsyncCheckpointer()
    eval_det, best_ap = None, -1.0   # one eval model, refreshed by set_params

    def log_row(row):
        if is_main:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def on_log(it, losses, info):
        log_row({"iter": it, "time": time.time(), **losses, "size": info["size"],
                 "step_s": info["step_s"], "imgs_per_sec": info["imgs_per_sec"],
                 "tflops": info["tflops"], "mfu": info["mfu"]})

    def after_step(st: TrainState):
        nonlocal eval_det, best_ap
        it = st.step
        # the unit that crosses a multiple of the cadence saves / evals
        if it % tc["save_iter"] < scan_steps and it >= tc["save_iter"]:
            if dcp_ckpt is not None:
                dcp_ckpt.save(it, st)   # every rank takes part
            if is_main:
                # joins the previous write, so GC sees every earlier file
                # finished and skips this one's temporary
                ckpt.save_step(os.path.join(weights_dir, f"step{it:08d}.npz"),
                               eval_state_dict(st),
                               os.path.join(weights_dir, "last_state.npz"), st)
                gc_checkpoints(weights_dir, keep=10)
                logger.info("saved %s/step%08d.npz", weights_dir, it)
        if (is_main and it % tc["eval_iter"] < scan_steps and it >= tc["eval_iter"]
                and os.path.exists(cfg.val_path)):
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

    if tc.get("warmup_shapes") and getattr(cfg, "randomShape", None):
        def on_size(size, secs):
            logger.info("warmup %dx%d: %.1fs", size, size, secs)
            log_row({"warmup_size": int(size), "secs": round(secs, 2), "time": time.time()})

        warmup_units(unit_step, cfg, dev, sizes=cfg.randomShape["sizes"],
                     scan_steps=scan_steps, on_size=on_size)

    host = Prefetcher(train_batches(records, cfg, seed=0, start_iter=start_iter,
                                    shape_group=scan_steps, num_shards=dist.world(),
                                    shard_id=dist.rank()),
                      max_batch=max(tc.get("max_batch", 3), scan_steps))
    try:
        state = step_loop(state, unit_step, DevicePrefetcher(stack_units(host, scan_steps), dev),
                          generator, max_iters=int(tc["max_iters"]),
                          log_every=int(tc.get("log_iter", 20)), n_steps=scan_steps,
                          on_log=on_log, after_step=after_step)
    finally:
        host.close()
        ckpt.wait()
    if is_main:
        gc_checkpoints(weights_dir, keep=10)
    dist.barrier()   # rank 0's files are whole before any rank reads one (a resume)
    logger.info("done at iter %d", state.step)
    return state


def main(argv: Optional[list] = None) -> TrainState:
    from configs import get_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--use_gpu", type=str2bool, default=True,
                   help="False runs on the host CPU")
    p.add_argument("--ndev", type=int, default=None,
                   help="cards, one process each (default: the world size)")
    p.add_argument("--precision", type=str, default="fp32", choices=["fp32", "bf16"],
                   help="bf16 = mixed-precision forward (fp32 masters)")
    p.add_argument("--scan_steps", type=int, default=1,
                   help=">1 steps that many batches as one unit (one CUDA graph replay)")
    p.add_argument("--weights_dir", type=str, default="./weights")
    args = p.parse_args(argv)
    cfg = get_config(args.config)
    cfg.train_cfg["precision"] = args.precision
    cfg.train_cfg["scan_steps"] = args.scan_steps
    with dist.env_group(None if args.use_gpu else "cpu") as device:
        return run_training(cfg, weights_dir=args.weights_dir, ndev=args.ndev, device=device)


if __name__ == "__main__":
    from ..utils.logger import setup_logger

    setup_logger()
    main()
