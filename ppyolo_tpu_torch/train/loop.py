"""The training loop of the port: the inner loop of ``train.py:265-293``.

``step_loop`` is the one stepping loop: it takes device batches (from a
``data.loader.DevicePrefetcher``, whose copy of batch N+1 runs beside
step N's kernels), steps, and every ``train_cfg['log_iter']`` steps reads the losses
(a sync with the card) and hands them to ``on_log`` with the window's
seconds per step.  ``after_step`` runs after every step (the entry's
checkpoints and evals); its time is kept out of the next window.

``run_training`` drives it on batches the caller supplies (an iterator of
dicts of numpy arrays: 'image' uint8 NHWC, 'gt_bbox', 'gt_class',
'gt_score' or 'targets'); ``entry/train.py`` drives it on the COCO loader.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..data.loader import DevicePrefetcher
from ..models import PPYOLO
from ..ops.ema import ema_apply
from ..ops.module import resolve_device
from .train_step import TrainState, init_train_state, make_train_step

logger = logging.getLogger(__name__)

PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def step_loop(state: TrainState, step_fn, batches: Iterable[Tuple[Dict, Dict]],
              generator: torch.Generator, *, max_iters: int, log_every: int,
              on_log: Optional[Callable[[int, Dict[str, float], Dict], None]] = None,
              after_step: Optional[Callable[[TrainState], None]] = None) -> TrainState:
    """Step on ``(device_batch, host_batch)`` pairs until ``state.step``
    reaches ``max_iters`` or the batches run out; a batch is asked for only
    when a step will take it.  ``on_log(step, losses,
    info)`` gets each logged record; ``info`` holds the batch's ``size``
    [H, W], ``step_s`` (the mean wall time of a step since the last log)
    and ``imgs_per_sec``."""
    t0, n_steps = time.time(), 0
    batches = iter(batches)
    while state.step < max_iters:
        item = next(batches, None)
        if item is None:
            break
        batch = item[0]
        state, losses = step_fn(state, batch, generator)
        n_steps += 1
        if log_every > 0 and state.step % log_every == 0:
            vals = {k: float(v) for k, v in losses.items()}   # syncs with the card
            step_s = (time.time() - t0) / n_steps
            n, h, w = batch["image"].shape[:3]
            info = {"size": [int(h), int(w)], "step_s": step_s, "imgs_per_sec": n / step_s}
            msg = ", ".join(f"{k}={v:.3f}" for k, v in vals.items())
            logger.info("iter %d, %s, %.1f imgs/s", state.step, msg, info["imgs_per_sec"])
            if on_log is not None:
                on_log(state.step, vals, info)
            t0, n_steps = time.time(), 0
        if after_step is not None:
            ta = time.time()
            after_step(state)
            t0 += time.time() - ta
    return state


def run_training(cfg, batches: Iterable[Dict], *, device=None,
                 max_iters: Optional[int] = None,
                 model: Optional[PPYOLO] = None, seed: int = 0,
                 log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
                 after_step: Optional[Callable[[TrainState], None]] = None,
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Train ``model`` (default: ``cfg``'s model, random init from ``seed``)
    on ``batches`` for ``max_iters`` steps (default ``train_cfg
    ['max_iters']``) or until the batches run out.  ``device`` defaults to
    CUDA and raises without a card; precision is ``train_cfg['precision']``
    (fp32 or bf16 mixed).  ``log_fn(step, losses)`` receives each logged
    record; ``after_step(state)`` runs after every step.  Returns the state
    and the EMA-applied state dict."""
    dev = resolve_device(device)
    tc = cfg.train_cfg
    if model is None:
        model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    step_fn = make_train_step(model, cfg,
                              compute_dtype=PRECISIONS[tc.get("precision", "fp32")])
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    state = step_loop(
        state, step_fn, DevicePrefetcher(batches, dev), generator,
        max_iters=int(tc["max_iters"] if max_iters is None else max_iters),
        log_every=int(tc.get("log_iter", 20)),
        on_log=None if log_fn is None else (lambda step, vals, _: log_fn(step, vals)),
        after_step=after_step)
    sd = model.state_dict()
    return state, (ema_apply(sd, state.ema) if state.ema is not None else dict(sd))
