"""Time every launch plan of K5 (the int8 conv) at ppyolo_2x@608 b8's int8 conv
shapes, and fit ``ops/conv_int8.py``'s cost model to those times.

On the card (``python -m ppyolo_tpu_torch.tools.k5_plans``): for each of the
32 shapes (``eval.optimize.int8_conv_shapes``), every plan of
``k5_candidates`` (each warpgroup layout, each number of Co tiles a block
walks) is launched on the same inputs, held
bit-equal to ``quantized_conv2d_plain`` (a static scale), and timed with
CUDA events over 20 launches.  One JSON line per shape: its times by plan
(``"<wg_m><m_tiles>/<tiles_per_block>"``), ``k5_plan``'s pick, and the
model's cycles; then the totals a b8 batch of the picks and of each shape's
fastest plan.

On the CPU (``--fit FILE``, FILE that output): a seeded random search over
the cost model's six constants for the ones whose picks take the least
total time on those measurements; prints the best few.  Beside them, what
simpler choices would take on the same times: the fixed rule of
``rule_plan``, and the model and the fastest plans without the BM 256
layout.
"""
from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

import torch

from ..ops import conv_int8 as ci

BATCH, SIZE, ITERS = 8, 608, 20
CONSTANTS = ("_OPS_CYCLE", "_DRAM_B_CYCLE", "_L2_B_CYCLE", "_QUANT_CYCLE", "_FIXED_CYCLES",
             "_OVERLAP")
RANGES = ((0.2 * 8192, 8192), (3, 20), (5, 60), (1, 16), (0, 8000), (0, 1))


def key(p) -> str:
    return f"{p.wg_m}{p.m_tiles}/{p.tiles_per_block}"


def measure() -> list:
    from configs import PPYOLO_2x_Config

    from ..eval.optimize import int8_conv_shapes
    from ..models import PPYOLO

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the plans are timed on the card")
    dev, gen, rows = torch.device("cuda"), torch.Generator().manual_seed(0), []
    launch = ci._launch()
    stream = torch.cuda.current_stream().cuda_stream
    sms = ci.sm_count(dev)
    for c, h, w, co, k, stride, count in int8_conv_shapes(
            PPYOLO.from_config(PPYOLO_2x_Config()).eval(), SIZE, BATCH):
        x = (torch.randn(BATCH, c, h, w, generator=gen) * 1.5).to(dev, torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        wq = torch.randint(-127, 128, (co, c, k, k), generator=gen, dtype=torch.int8).to(dev)
        ws = (torch.rand(co, generator=gen) * 1e-3 + 1e-4).to(dev)
        s_x = ci.dynamic_act_scale(x) * 0.6
        packed = ci.pack_int8_weight(wq)
        want = ci.quantized_conv2d_plain(x, wq, ws, stride=stride, padding=(k - 1) // 2,
                                         act_scale=s_x)
        oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
        y = torch.empty(BATCH, co, oh, ow, dtype=x.dtype, device=dev,
                        memory_format=torch.channels_last)
        shape = (BATCH, h, w, c, co, k, stride)
        times = {}
        for p in ci.k5_candidates(*shape, sms):
            args = (x.data_ptr(), packed.data_ptr(), ws.data_ptr(), s_x.data_ptr(), 0,
                    y.data_ptr(), BATCH, h, w, c, co, k, stride, p.wg_m, p.m_tiles,
                    p.tiles_per_block, p.planes[1], p.planes[2], p.a_slots, p.c_chunk, *p.grid,
                    p.smem_bytes, stream)
            y.zero_()
            if launch(*args) != 0:
                raise RuntimeError(f"K5 {shape} plan {key(p)}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"K5 {shape} plan {key(p)}: not bit-equal")
            for _ in range(3):
                launch(*args)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(ITERS):
                launch(*args)
            end.record()
            torch.cuda.synchronize()
            times[key(p)] = [start.elapsed_time(end) / ITERS, p.cost_cycles]
        row = {"shape": list(shape), "convs": count, "pick": key(ci.k5_plan(*shape, sms)),
               "times": times}
        rows.append(row)
        print(json.dumps(row), flush=True)
    picked = sum(r["convs"] * r["times"][r["pick"]][0] for r in rows)
    fastest = sum(r["convs"] * min(t[0] for t in r["times"].values()) for r in rows)
    print(json.dumps({"picked_ms_per_batch": picked, "fastest_ms_per_batch": fastest,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return rows


def rule_plan(shape, layouts=((2, 1), (1, 1))):
    """The fixed rule the cost model is held against: the first of
    ``layouts`` that fits (BM 128 x BN 128, else BM 64 x BN 256), with the
    fewest Co splits whose blocks fill one wave of the SMs (blocks an SM
    counted), else the most."""
    plans = ci.k5_candidates(*shape)
    for layout in layouts:
        same = sorted((p for p in plans if (p.wg_m, p.m_tiles) == layout),
                      key=lambda p: p.co_splits)
        if same:
            full = [p for p in same if p.grid[0] * p.grid[1] >= ci.SMS * p.blocks_per_sm]
            return full[0] if full else same[-1]
    raise ValueError(f"K5 {shape}: no plan of the layouts {layouts}")


def batch_ms(rows, choose) -> float:
    """The total time a batch of the plan ``choose(shape)`` picks."""
    return sum(r["convs"] * r["times"][key(choose(tuple(r["shape"])))][0] for r in rows)


def picked_ms(rows, constants) -> float:
    """The total time a batch of the plans the model with ``constants`` picks."""
    saved = [getattr(ci, n) for n in CONSTANTS]
    try:
        for name, v in zip(CONSTANTS, constants):
            setattr(ci, name, v)
        total = 0.0
        for r in rows:
            best = min(ci.k5_candidates(*r["shape"]),
                       key=lambda p: (p.cost_cycles, p.quant_per_element))
            total += r["convs"] * r["times"][key(best)][0]
        return total
    finally:
        for name, v in zip(CONSTANTS, saved):
            setattr(ci, name, v)


def fit(rows, samples: int = 4000, seed: int = 1) -> list:
    """[(picked ms a batch, constants)], best first: the current constants
    and ``samples`` seeded random draws from RANGES."""
    rng = random.Random(seed)
    cands = [[getattr(ci, n) for n in CONSTANTS]]
    cands += [[rng.uniform(lo, hi) for lo, hi in RANGES] for _ in range(samples)]
    return sorted(((picked_ms(rows, c), c) for c in cands), key=lambda t: t[0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fit", type=Path, help="fit the cost model to this output of a card run")
    ap.add_argument("--samples", type=int, default=4000)
    a = ap.parse_args(argv)
    if a.fit is None:
        measure()
        return
    rows = [json.loads(ln) for ln in a.fit.read_text().splitlines() if ln.startswith('{"shape"')]
    fastest = sum(r["convs"] * min(t[0] for t in r["times"].values()) for r in rows)
    no256 = sum(r["convs"] * min(t[0] for k, t in r["times"].items() if not k.startswith("22"))
                for r in rows)
    model_no256 = batch_ms(rows, lambda s: min(
        (p for p in ci.k5_candidates(*s) if p.m_tiles == 1),
        key=lambda p: (p.cost_cycles, p.quant_per_element)))
    print(json.dumps({"fastest_ms_per_batch": fastest, "model_ms_per_batch":
                      batch_ms(rows, lambda s: ci.k5_plan(*s)),
                      "fixed_rule_ms_per_batch": batch_ms(rows, rule_plan),
                      "model_without_bm256_ms_per_batch": model_no256,
                      "fastest_without_bm256_ms_per_batch": no256}))
    for ms, cand in fit(rows, a.samples)[:8]:
        print(json.dumps({"picked_ms_per_batch": ms,
                          "constants": dict(zip(CONSTANTS, [round(v, 3) for v in cand]))}))


if __name__ == "__main__":
    main()
