"""The training loop of the port: the inner loop of ``train.py:265-293``.

``step_loop`` is the one stepping loop: it takes device units (from a
``data.loader.DevicePrefetcher``, whose copy of unit N+1 runs beside unit
N's kernels) and steps.  A unit is one batch, or ``n_steps`` batches
stacked on a leading axis for a multi-step function
(``make_multi_train_step``; ``train.py:191-200``).  On a card each unit is
one replay of a CUDA graph (``train/graphs.py::GraphedStep``).  When a unit
ends on a ``train_cfg['log_iter']`` boundary (JAX's ``will_log`` rule,
``train.py:269-270``) it reads the unit's last losses (a sync with the
card), logs the JAX entry's line (``iter, losses, imgs/s, TFLOP/s (mfu),
eta``; the unit's FLOPs from its first run, ``utils/mfu.py``) and hands
the record to ``on_log`` with the window's seconds per step.
``after_step`` runs after every unit (the entry's checkpoints and evals);
its time is kept out of the next window.  Under a process group only rank
0 reads and logs the losses, which the step averaged over the ranks
(``train.py``'s ``is_main``); every rank steps.

``run_training`` drives it on batches the caller supplies (an iterator of
dicts of numpy arrays: 'image' uint8 NHWC, 'gt_bbox', 'gt_class',
'gt_score' or 'targets'); ``entry/train.py`` drives it on the COCO loader.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..data.loader import DevicePrefetcher, stack_units
from ..models import PPYOLO
from ..ops.ema import ema_apply
from ..ops.module import resolve_device
from ..parallel import dist
from ..utils.logger import TrainMeter
from ..utils.mfu import mfu
from ..utils.profiling import span
from .graphs import GraphedStep
from .train_step import TrainState, init_train_state, make_multi_train_step, make_train_step

logger = logging.getLogger(__name__)

PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def will_log(step: int, n_steps: int, log_every: int) -> bool:
    """Does the unit that starts at ``step`` and takes ``n_steps`` log?"""
    return log_every > 0 and (step + n_steps) % log_every < n_steps


def make_unit_step(model, cfg, state: TrainState, generator: Optional[torch.Generator], *,
                   n_steps: int = 1, compute_dtype: torch.dtype = torch.float32,
                   target_pipeline: Optional[str] = None,
                   capture: bool = True) -> GraphedStep:
    """The unit of work of a run: one train step, or ``n_steps`` of them
    (``make_multi_train_step``), as a ``GraphedStep`` on ``state``
    (eager on a card with ``capture=False``)."""
    if n_steps > 1:
        fn = make_multi_train_step(model, cfg, n_steps=n_steps, compute_dtype=compute_dtype,
                                   target_pipeline=target_pipeline)
    else:
        fn = make_train_step(model, cfg, compute_dtype=compute_dtype)
    return GraphedStep(fn, state, generator, n_steps=n_steps, capture=capture)


def step_loop(state: TrainState, step_fn, units: Iterable[Tuple[Dict, Dict]],
              generator: Optional[torch.Generator], *, max_iters: int, log_every: int,
              n_steps: int = 1,
              on_log: Optional[Callable[[int, Dict[str, float], Dict], None]] = None,
              after_step: Optional[Callable[[TrainState], None]] = None) -> TrainState:
    """Step on ``(device_unit, host_unit)`` pairs until ``state.step``
    reaches ``max_iters`` or the units run out; a unit is asked for only
    when it will be stepped.  ``step_fn`` takes ``n_steps`` steps a unit
    (losses stacked to ``[n_steps]`` when ``n_steps > 1``).  ``on_log(step,
    losses, info)`` gets each logged record: the unit's last losses;
    ``info`` holds the batch's ``size`` [H, W], ``step_s`` (the mean wall
    time of a step since the last log), ``imgs_per_sec``, ``tflops`` (all
    ranks' TFLOP/s) and ``mfu`` (None where the FLOPs or the card's peak
    are unknown: ``utils/mfu.py``) and ``eta_h``, the hours left at the mean
    step time of the last 20 logs."""
    t0, n_done = time.time(), 0
    units = iter(units)
    is_main = dist.rank() == 0
    meter = TrainMeter()
    unit_flops = getattr(step_fn, "unit_flops", lambda unit: None)
    while state.step < max_iters:
        with span("train.unit"):    # the root of the unit's spans
            with span("train.feed"):
                item = next(units, None)
            if item is None:
                break
            unit = item[0]
            logs = is_main and will_log(state.step, n_steps, log_every)
            with span("train.step"):
                state, losses = step_fn(state, unit, generator)
        n_done += n_steps
        if logs:
            if n_steps > 1:
                losses = {k: v[-1] for k, v in losses.items()}
            vals = {k: float(v) for k, v in losses.items()}   # syncs with the card
            step_s = (time.time() - t0) / n_done
            meter.update(step_s)
            n, h, w = unit["image"].shape[-4:-1]
            flops = unit_flops(unit)
            flops = flops * dist.world() if flops else None
            unit_s = step_s * n_steps
            u = mfu(flops, unit_s, n_chips=dist.world(), device=state.step_t.device)
            info = {"size": [int(h), int(w)], "step_s": step_s, "imgs_per_sec": n / step_s,
                    # 6 places, not JAX's 3: a CPU step's TFLOP/s is below 1e-3
                    "tflops": round(flops / unit_s / 1e12, 6) if flops else None,
                    "mfu": round(u, 4) if u is not None else None,
                    "eta_h": meter.eta_hours(max_iters - state.step)}
            msg = ", ".join(f"{k}={v:.3f}" for k, v in vals.items())
            perf = ""
            if flops:
                perf = f", {flops / unit_s / 1e12:.2f} TFLOP/s"
                if u is not None:
                    perf += f" (mfu {u:.1%})"
            logger.info("iter %d, %s, %.1f imgs/s%s, eta %.1fh", state.step, msg,
                        info["imgs_per_sec"], perf, info["eta_h"])
            if on_log is not None:
                on_log(state.step, vals, info)
            t0, n_done = time.time(), 0
        if after_step is not None:
            ta = time.time()
            after_step(state)
            t0 += time.time() - ta
    return state


def run_training(cfg, batches: Iterable[Dict], *, device=None,
                 max_iters: Optional[int] = None,
                 model: Optional[PPYOLO] = None, seed: int = 0,
                 log_fn: Optional[Callable[[int, Dict[str, float], Dict], None]] = None,
                 after_step: Optional[Callable[[TrainState], None]] = None,
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Train ``model`` (default: ``cfg``'s model, random init from ``seed``)
    on ``batches`` for ``max_iters`` steps (default ``train_cfg
    ['max_iters']``) or until the batches run out.  ``device`` defaults to
    CUDA and raises without a card; precision is ``train_cfg['precision']``
    (fp32 or bf16 mixed), and ``train_cfg['scan_steps']`` batches make a
    unit of work.  ``log_fn(step, losses, info)`` receives each logged
    record (``step_loop``'s ``on_log``); ``after_step(state)`` runs after every unit.  Returns the state
    and the EMA-applied state dict."""
    dev = resolve_device(device)
    tc = cfg.train_cfg
    if model is None:
        model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))
    model.to(device=dev, memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    n_steps = int(tc.get("scan_steps", 1))
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    unit_step = make_unit_step(model, cfg, state, generator, n_steps=n_steps,
                               compute_dtype=PRECISIONS[tc.get("precision", "fp32")],
                               capture=dist.can_capture(dev))
    state = step_loop(
        state, unit_step, DevicePrefetcher(stack_units(batches, n_steps), dev), generator,
        max_iters=int(tc["max_iters"] if max_iters is None else max_iters),
        log_every=int(tc.get("log_iter", 20)), n_steps=n_steps,
        on_log=log_fn,
        after_step=after_step)
    sd = model.state_dict()
    return state, (ema_apply(sd, state.ema) if state.ema is not None else dict(sd))
