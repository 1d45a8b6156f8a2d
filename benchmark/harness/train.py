"""The training runner: the program's graphed train step on seeded batches.

Set-up builds one training object (the port's model from the seeded fp32
weights, ``init_train_state`` with its EMA shadow, the one-step unit
``make_unit_step`` with its DropBlock generator) and a ``DevicePrefetcher``
over the seeded host batches, and takes the job's first ``check_steps``
steps through them: the first captures the graph, each steps on a batch of
its own, and the LR is the recipe's warmup from 0.  The window then hands
the same state, unit and feed to ``train/loop.py::step_loop``, the loop
``run_training`` runs, and ends at a synchronize after its last step; the
batches end at the deadline.

The output check follows the first steps in the reference
(``reference/train.py``): the optimizer's first gradient (its momentum
buffer after one step), and the change from the start of the parameters,
of the EMA shadow and of the BN running statistics after the last step.
``precision`` ("fp8", the control; "bf16", the witness of bf16 rounding)
and the faults ``half_batch`` and ``ema_unchanged`` put the reference, so
changed, in the program's place.
"""
from __future__ import annotations

import copy
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from ..reference import train as reftrain
from ..work import counts
from . import card, trace, traffic, weights

REFERENCE_FAULTS = ("half_batch", "ema_unchanged")


def train_cfg(cfg_file: dict, t: dict) -> dict:
    """The configuration as the job runs it: the traffic's ``freeze_at``,
    batch and the configuration's training precision."""
    cfg = copy.deepcopy(cfg_file["fields"])
    cfg["backbone"]["freeze_at"] = t["freeze_at"]
    cfg["train_cfg"].update(batch_size=t["batch"], precision=cfg_file["precision"]["train"],
                            scan_steps=1)
    return cfg


def drop_seed(seed: int) -> int:
    return int(seed) % 2 ** 62 + 1


class Feed:
    """Host batches from the pool in turn until ``deadline`` (if set)
    passes or ``budget`` batches (if set) were taken."""

    def __init__(self, pool: List[dict]):
        self.pool, self.i, self.deadline, self.budget = pool, 0, None, None

    def __iter__(self):
        while True:
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            if self.budget is not None:
                if self.budget <= 0:
                    return
                self.budget -= 1
            b = self.pool[self.i % len(self.pool)]
            self.i += 1
            yield b


def norms_from(start: Dict[str, torch.Tensor], now: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{key: |now - start|} over ``now``'s keys, in one device call."""
    keys = list(now)
    with torch.no_grad():
        n = torch._foreach_norm(torch._foreach_sub([now[k].detach().float() for k in keys],
                                                   [start[k].float() for k in keys]))
    return dict(zip(keys, torch.stack(n).tolist()))


def run(cfg_file: dict, t: dict, seed: int, seconds: float, traced: bool, t_start: float,
        chips: int = 1, device=None, precision: str = None, fault: str = None) -> dict:
    if chips != 1:
        raise ValueError("the training runner runs one card")
    device = torch.device(device or "cuda")
    cfg = train_cfg(cfg_file, t)
    P = weights.make_state_dict(cfg, seed, device, t["size"])
    pool = traffic.train_batches(t, cfg, seed)
    kw = dict(drop_seed=drop_seed(seed), device=device, n=t["check_steps"])
    if precision is not None or fault is not None:
        if precision not in (None, "fp8", "bf16") or fault not in (None,) + REFERENCE_FAULTS:
            raise ValueError(f"no training control {precision!r} or fault {fault!r}")
        refr = reftrain.steps(cfg, P, pool, **kw)
        placed = reftrain.steps(cfg, P, pool, quant=precision, half_batch=fault == "half_batch",
                                ema=fault != "ema_unchanged", **kw)
        return dict(e2e={}, setup_s=time.time() - t_start, device_name=card.name(device),
                    attempted=0, failed=0, memory_peak=0, record=None,
                    readings=reftrain.readings(placed, refr))

    from ppyolo_tpu_torch.data.loader import DevicePrefetcher, stack_units
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.loop import PRECISIONS, make_unit_step, step_loop
    from ppyolo_tpu_torch.train.train_step import init_train_state

    ns = SimpleNamespace(**cfg)
    card.reset_peak(device)     # the peak from here on is the program's
    model = PPYOLO.from_config(ns)
    model.load_state_dict(P)
    model.to(device=device, memory_format=torch.channels_last)
    state = init_train_state(model, ns)
    gen = torch.Generator(device=device).manual_seed(drop_seed(seed))
    unit = make_unit_step(model, ns, state, gen, n_steps=1,
                          compute_dtype=PRECISIONS[cfg["train_cfg"]["precision"]],
                          capture=dist.can_capture(device))
    feed = Feed(pool)
    units = DevicePrefetcher(stack_units(iter(feed), 1), device)
    keys = list(state.trainable)
    losses_t = []
    for i in range(t["check_steps"]):
        dev_unit, _ = next(units)
        state, losses = unit(state, dev_unit, gen)
        losses_t.append(losses["total_loss"].clone())
        if i == 0:
            grad = dict(zip(keys, torch.stack(torch._foreach_norm(
                [state.optimizer.bufs[k] for k in keys])).tolist()))
    stats = {k: b for k, b in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    prog = {"loss": [float(v) for v in losses_t], "grad": grad,
            "step": norms_from(P, state.trainable),
            "ema": norms_from(P, state.ema) if state.ema is not None else {},
            "bn": norms_from(P, stats)}

    def steps(n=None, deadline=None, step_fn=unit):
        """``step_loop`` over the next ``n`` batches (or until ``deadline``)."""
        feed.budget, feed.deadline = n, deadline
        return step_loop(state, step_fn, DevicePrefetcher(stack_units(iter(feed), 1), device),
                         gen, max_iters=2 ** 62, log_every=0)

    card.sync(device)
    setup_s = time.time() - t_start

    start = state.step
    tw = time.perf_counter()
    state = steps(deadline=time.perf_counter() + seconds)
    card.sync(device)
    window_s = time.perf_counter() - tw
    n_steps = state.step - start
    memory_peak = card.peak_bytes(device)

    rec = None
    if traced:
        spans: Dict[str, list] = {"step": []}

        def spanned(st, u, g):
            t0 = time.time_ns()
            out = unit(st, u, g)
            spans["step"].append((t0, time.time_ns()))
            return out

        state = steps(1)    # a new feed's first buffers come from cudaMalloc: not in the trace
        with trace.device_trace() as prof:
            state = steps(t["trace_units"], step_fn=spanned)
        dev, host = trace.device_records(prof)
        work = counts.model_flops(cfg, t["size"], t["batch"], train=True)
        rec = dict(kind="train", chips=1, device_name=card.name(device),
                   units=t["trace_units"], steps=t["trace_units"],
                   images=t["trace_units"] * t["batch"], dev=dev, host=host, spans=spans,
                   busy_s=trace.busy_ns(dev) / 1e9, window_s=trace.span_ns(dev) / 1e9,
                   flops_per_image=work["flops"] / t["batch"], dcn_layers=work["dcn_layers"])

    finite = all(np.isfinite(prog["loss"]))
    del unit, state, model, units, losses_t, stats
    card.release(device)
    refr = reftrain.steps(cfg, P, pool, **kw)
    return dict(
        e2e={"train_img_per_s": (n_steps * t["batch"] / window_s, "img/s")},
        setup_s=setup_s, device_name=card.name(device), attempted=n_steps,
        failed=0 if finite else n_steps, memory_peak=memory_peak,
        readings=reftrain.readings(prog, refr), record=rec)
