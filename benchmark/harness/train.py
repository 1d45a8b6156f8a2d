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

On more than one card (``chips``; ``harness/ranks.py``) every rank does
the same on its own card with its own batches, from the same weights
(rank 0's, broadcast) and a DropBlock generator seeded alike on every
rank, as the program's training entry seeds it; the traffic's
``norm_type`` is ``sync_bn``.  Ranks that stopped apart would wait in a
collective for ever, so the window is a fixed number of steps on every
rank: as many as rank 0's timed ``RATE_STEPS`` after the first steps say
fill ``seconds``.  Its rate counts every rank's images over rank 0's
window.

The output check follows the first steps in the reference
(``reference/train.py``, on ranks the group's step with sync-BN): the
optimizer's first gradient (its momentum buffer after one step), and the
change from the start of the parameters, of the EMA shadow and of the BN
running statistics after the last step; on ranks, rank 0's.
``precision`` ("fp8", the control; "bf16", the witness of bf16 rounding)
and the faults ``half_batch`` and ``ema_unchanged`` put the reference, so
changed, in the program's place; ``harness/faults.py``'s program faults
(``no_exchange``, ``no_grad_exchange``) are planted in the program.

Every rank prints on stderr the seconds from the run's start at which it
passed each step of its set-up (``ranks.MARKS``).
"""
from __future__ import annotations

import copy
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as tdist

from ..reference import for_config
from ..reference import train as reftrain
from ..work import counts
from . import card, faults, ranks, trace, traffic, weights

REFERENCE_FAULTS = ("half_batch", "ema_unchanged")
RATE_STEPS = 5


def train_cfg(cfg_file: dict, t: dict) -> dict:
    """The configuration as the job runs it: the traffic's ``freeze_at``,
    batch, ``norm_type`` (where it sets one) and the configuration's
    training precision."""
    cfg = copy.deepcopy(cfg_file["fields"])
    cfg["backbone"]["freeze_at"] = t["freeze_at"]
    if "norm_type" in t:
        cfg["backbone"]["norm_type"] = cfg["head"]["norm_type"] = t["norm_type"]
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


def group() -> tuple:
    """(world, rank) of the process group, (1, 0) without one."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def state_dict(ref, cfg, seed: int, device, size: int) -> Dict[str, torch.Tensor]:
    """The seeded fp32 weights; on ranks rank 0's, broadcast to every rank
    in the reference's key order."""
    world, rank = group()
    if world == 1:
        return weights.make_state_dict(ref, cfg, seed, device, size)
    shapes = ref.param_shapes(cfg)
    if rank == 0:
        P = weights.make_state_dict(ref, cfg, seed, device, size)
        flat = torch.cat([P[k].reshape(-1) for k in shapes])
        del P
    else:
        flat = torch.empty(sum(torch.Size(s).numel() for s in shapes.values()), device=device)
    tdist.broadcast(flat, 0)
    parts = flat.split([torch.Size(s).numel() for s in shapes.values()])
    return {k: part.view(s).clone() for (k, s), part in zip(shapes.items(), parts)}


def over_ranks(values: List[float], op, device) -> List[float]:
    """``values`` reduced by ``op`` over the ranks (as they are without a group)."""
    if group()[0] == 1:
        return values
    v = torch.tensor(values, dtype=torch.float64, device=device)
    tdist.all_reduce(v, op=op)
    return v.tolist()


def print_marks(rank: int, t_start: float) -> None:
    """This process's set-up marks (``ranks.MARKS``) as seconds from the
    run's start, one line on stderr."""
    line = ", ".join(f"{name} {at - t_start:.2f}" for name, at in ranks.MARKS)
    print(f"benchmark: rank {rank} set-up, s from start: {line}", file=sys.stderr, flush=True)
    ranks.MARKS.clear()


def run(cfg_file: dict, t: dict, seed: int, seconds: float, traced: bool, t_start: float,
        chips: int = 1, device=None, precision: str = None, fault: str = None) -> dict:
    spec = dict(cfg_file=cfg_file, t=t, seed=seed, seconds=seconds, traced=traced,
                t_start=t_start, precision=precision, fault=fault)
    if chips > 1:
        return ranks.lead(chips, torch.device(device or "cuda").type, __name__, spec)
    return run_rank(**spec, device=device)


def run_rank(cfg_file: dict, t: dict, seed: int, seconds: float, traced: bool, t_start: float,
             device=None, precision: str = None, fault: str = None) -> dict:
    """This process's run: the whole run on one card, or one rank's share
    (module docstring); the result is rank 0's."""
    if fault in faults.PROGRAM:
        with faults.PROGRAM[fault]():
            return run_rank(cfg_file, t, seed, seconds, traced, t_start, device, precision)
    ranks.mark("entered")
    world, rank = group()
    if world > 1 and t.get("norm_type") != "sync_bn":
        raise ValueError("the training runner runs ranks with sync_bn")
    device = torch.device(device or "cuda")
    ref = for_config(cfg_file)
    cfg = train_cfg(cfg_file, t)
    P = state_dict(ref, cfg, seed, device, t["size"])
    ranks.mark("weights")
    pool = traffic.train_batches(t, cfg, seed, rank)
    ranks.mark("batches")
    kw = dict(drop_seed=drop_seed(seed), device=device, n=t["check_steps"], ranks=world > 1)
    if precision is not None or fault is not None:
        if precision not in (None, "fp8", "bf16") or fault not in (None,) + REFERENCE_FAULTS:
            raise ValueError(f"no training control {precision!r} or fault {fault!r}")
        refr = reftrain.steps(ref, cfg, P, pool, **kw)
        ranks.MARKS.clear()
        placed = reftrain.steps(ref, cfg, P, pool, quant=precision,
                                half_batch=fault == "half_batch",
                                ema=fault != "ema_unchanged", **kw)
        return dict(e2e={}, setup_s=time.time() - t_start, device_name=card.name(device),
                    attempted=0, failed=0, memory_peak=0, record=None,
                    readings=reftrain.readings(placed, refr))

    from ppyolo_tpu_torch.data.loader import DevicePrefetcher, stack_units
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.loop import PRECISIONS, make_unit_step, step_loop
    from ppyolo_tpu_torch.train.train_step import init_train_state

    ranks.mark("imports")
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
    ranks.mark("model")
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
    ranks.mark("first steps")

    def steps(n=None, deadline=None, step_fn=unit):
        """``step_loop`` over the next ``n`` batches (or until ``deadline``)."""
        feed.budget, feed.deadline = n, deadline
        return step_loop(state, step_fn, DevicePrefetcher(stack_units(iter(feed), 1), device),
                         gen, max_iters=2 ** 62, log_every=0)

    budget = None
    if world > 1:
        card.sync(device)
        t0 = time.perf_counter()
        state = steps(RATE_STEPS)
        card.sync(device)
        n = torch.tensor([max(1, round(seconds * RATE_STEPS / (time.perf_counter() - t0)))],
                         device=device)
        tdist.broadcast(n, 0)
        budget = int(n)
        ranks.mark("rate")
    card.sync(device)
    setup_s = time.time() - t_start
    ranks.mark("window")
    print_marks(rank, t_start)

    start = state.step
    tw = time.perf_counter()
    if budget is None:
        state = steps(deadline=time.perf_counter() + seconds)
    else:
        state = steps(budget)
    card.sync(device)
    window_s = time.perf_counter() - tw
    n_steps = state.step - start
    memory_peak = int(over_ranks([card.peak_bytes(device)], tdist.ReduceOp.MAX, device)[0])

    rec = None
    if traced:
        spans: Dict[str, list] = {"step": []}

        def spanned(st, u, g):
            t0 = time.time_ns()
            out = unit(st, u, g)
            spans["step"].append((t0, time.time_ns()))
            return out

        state = steps(1)    # a new feed's first buffers come from cudaMalloc: not in the trace
        if world > 1:
            # a process's first profiler start takes each rank its own time, and ranks
            # that enter the traced block apart wait in its first collective, which
            # rank 0's trace would count as exchange
            with trace.device_trace():
                pass
            tdist.barrier()
            card.sync(device)
        with trace.device_trace() as prof:
            state = steps(t["trace_units"], step_fn=spanned)
        dev, host = trace.device_records(prof)
        busy_s, span_s = trace.busy_ns(dev) / 1e9, trace.span_ns(dev) / 1e9
        mean = [v / world for v in over_ranks([busy_s, span_s], tdist.ReduceOp.SUM, device)]
        work = counts.model_flops(ref, cfg, t["size"], t["batch"], train=True)
        rec = dict(kind="train", chips=world, device_name=card.name(device),
                   units=t["trace_units"], steps=t["trace_units"],
                   images=t["trace_units"] * t["batch"], dev=dev, host=host, spans=spans,
                   busy_s=busy_s, window_s=span_s, chips_busy_s=mean[0], chips_window_s=mean[1],
                   flops_per_image=work["flops"] / t["batch"], dcn_layers=work["dcn_layers"])

    finite = all(np.isfinite(prog["loss"]))
    del unit, state, model, units, losses_t, stats
    card.release(device)
    refr = reftrain.steps(ref, cfg, P, pool, **kw)
    return dict(
        e2e={"train_img_per_s": (n_steps * t["batch"] * world / window_s, "img/s")},
        setup_s=setup_s, device_name=card.name(device), attempted=n_steps,
        failed=0 if finite else n_steps, memory_peak=memory_peak,
        readings=reftrain.readings(prog, refr), record=rec)
