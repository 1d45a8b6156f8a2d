"""The training loop of the port: the inner loop of ``train.py:265-293``.

The caller supplies the host batches (an iterator of dicts of numpy
arrays: 'image' uint8 NHWC, 'gt_bbox', 'gt_class', 'gt_score' or
'targets'), which is where a COCO loader plugs in.  Each batch is copied to
the device, stepped, and every ``train_cfg['log_iter']`` steps the losses
and img/s are logged (and handed to ``log_fn``, where the JAX loop appends
them to metrics.jsonl).  At the end the EMA shadow is applied to a copy of
the state dict, the parameters one would evaluate or save.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models import PPYOLO
from ..ops.ema import ema_apply
from ..ops.module import resolve_device
from .train_step import TrainState, init_train_state, make_train_step

logger = logging.getLogger(__name__)

BATCH_KEYS = ("image", "gt_bbox", "gt_class", "gt_score", "targets")
PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def to_device_batch(batch: Dict, device: torch.device) -> Dict:
    """H2D copy of the keys the step reads ('targets' is a sequence)."""
    def put(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)

    return {k: (tuple(put(t) for t in batch[k]) if k == "targets" else put(batch[k]))
            for k in BATCH_KEYS if k in batch}


def run_training(cfg, batches: Iterable[Dict], *, device=None,
                 max_iters: Optional[int] = None,
                 model: Optional[PPYOLO] = None, seed: int = 0,
                 log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Train ``model`` (default: ``cfg``'s model, random init from ``seed``)
    on ``batches`` for ``max_iters`` steps (default ``train_cfg
    ['max_iters']``) or until the batches run out.  ``device`` defaults to
    CUDA and raises without a card; precision is ``train_cfg['precision']``
    (fp32 or bf16 mixed).  ``log_fn(step, losses)`` receives each logged
    record.  Returns the state and the EMA-applied state dict."""
    dev = resolve_device(device)
    tc = cfg.train_cfg
    if model is None:
        model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    step_fn = make_train_step(model, cfg,
                              compute_dtype=PRECISIONS[tc.get("precision", "fp32")])
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    max_iters = int(tc["max_iters"] if max_iters is None else max_iters)
    log_every = int(tc.get("log_iter", 20))
    t0 = time.time()
    for batch in batches:
        if state.step >= max_iters:
            break
        n_img = batch["image"].shape[0]
        state, losses = step_fn(state, to_device_batch(batch, dev), generator)
        if log_every > 0 and state.step % log_every == 0:
            vals = {k: float(v) for k, v in losses.items()}   # syncs with the card
            dt = time.time() - t0
            msg = ", ".join(f"{k}={v:.3f}" for k, v in vals.items())
            logger.info("iter %d, %s, %.1f imgs/s", state.step, msg,
                        n_img * log_every / dt)
            if log_fn is not None:
                log_fn(state.step, vals)
            t0 = time.time()
    sd = model.state_dict()
    return state, (ema_apply(sd, state.ema) if state.ema is not None else dict(sd))
