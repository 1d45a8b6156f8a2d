"""The serving runner: one closed-loop caller of the program's ``Detector``.

Preprocessed traffic calls ``Detector.predict_batch`` on the pool's
batches in turn; ``frames`` traffic sends one BGR frame a call through
``Detector.process_image`` (the host resize, inside the benchmark's
``preprocess`` span) and then ``predict_batch`` at batch 1, the body of
``Detector.detect_image``.  Every call ends in the detections' copy to
the host, so the host clock around it times the whole request.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from ..reference import compare, for_config
from ..work import counts
from . import card, faults, trace, traffic, weights


class Spans:
    """The benchmark's own host spans, on the profiler's epoch clock."""

    def __init__(self, on: bool):
        self.on, self.spans = on, {}

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.on:
            self.spans.setdefault(name, []).append((t0, t1))


def setup(ref, cfg_file: dict, t: dict, seed: int, device, precision: str):
    """(the program's Detector, the fp32 weights, the call function, the pool)."""
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO

    cfg = cfg_file["fields"]
    P = weights.make_state_dict(ref, cfg, seed, device, t["size"])
    card.reset_peak(device)     # the peak from here on is the program's
    det = Detector(PPYOLO.from_config(SimpleNamespace(**cfg)), P, SimpleNamespace(**cfg),
                   target_size=t["size"], precision=precision, fold_bn=True, device=device)
    if t["frames"]:
        pool = traffic.frames(t, seed)

        def call(i, spans):
            t0 = time.time_ns()
            img, size = det.process_image(pool[i % len(pool)])
            spans.add("preprocess", t0, time.time_ns())
            return det.predict_batch(img, size)
    else:
        pool = traffic.serve_batches(t, seed)

        def call(i, spans):
            b = pool[i % len(pool)]
            return det.predict_batch(b["images"], b["im_size"])
    return det, P, call, pool


def p95_ms(lat_s: List[float]) -> float:
    """The 95th percentile of every call's latency, in ms."""
    return 1e3 * float(np.quantile(np.asarray(lat_s), 0.95))


def ok(out, t, keep_k) -> bool:
    return (isinstance(out, np.ndarray) and out.shape == (t["batch"], keep_k, 6)
            and bool(np.isfinite(out).all()))


def run(cfg_file: dict, t: dict, seed: int, seconds: float, traced: bool, t_start: float,
        chips: int = 1, precision: str = None, device=None, fault: str = None) -> dict:
    if fault in faults.PROGRAM:
        with faults.PROGRAM[fault]():
            return run(cfg_file, t, seed, seconds, traced, t_start, chips, precision, device)
    if chips != 1:
        raise ValueError("the serving runner runs one caller on one card")
    device = torch.device(device or "cuda")
    ref = for_config(cfg_file)
    cfg = cfg_file["fields"]
    keep_k = cfg["nms_cfg"]["keep_top_k"]
    det, P, call, pool = setup(ref, cfg_file, t, seed, device,
                               precision or cfg_file["precision"]["serve"])
    if fault is not None:
        served, plant = call, faults.SERVE[fault]()
        call = lambda i, spans: plant(served(i, spans), i)
    spans = Spans(False)
    for i in range(t["warmup_calls"]):
        call(i, spans)
    card.sync(device)
    setup_s = time.time() - t_start

    outs: List[np.ndarray] = []
    lat: List[float] = []
    failed = 0
    tw = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = call(len(outs), spans)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        outs.append(out)
        failed += not ok(out, t, keep_k)
        if t1 - tw >= seconds:
            break
    window_s = t1 - tw
    memory_peak = card.peak_bytes(device)

    rec = None
    if traced:
        spans = Spans(True)
        with trace.device_trace() as prof:
            for i in range(t["trace_units"]):
                t0 = time.time_ns()
                call(len(outs) + i, spans)
                spans.add("call", t0, time.time_ns())
        dev, host = trace.device_records(prof)
        work = counts.model_flops(ref, cfg, t["size"], t["batch"])
        rec = dict(kind="serve", chips=1, device_name=card.name(device),
                   units=t["trace_units"], images=t["trace_units"] * t["batch"],
                   dev=dev, host=host, spans=spans.spans, busy_s=trace.busy_ns(dev) / 1e9,
                   window_s=trace.span_ns(dev) / 1e9,
                   flops_per_image=work["flops"] / t["batch"], dcn_layers=work["dcn_layers"])

    # the sample: distinct pool entries among the calls that finished, in a
    # seeded order
    order = traffic.rng(seed, 3).permutation(len(outs))
    picked, seen = [], set()
    for i in order:
        if i % len(pool) not in seen and len(picked) < t["check_calls"]:
            seen.add(i % len(pool))
            picked.append(int(i))
    calls = []
    for i in picked:
        src = pool[i % len(pool)]
        if t["frames"]:
            calls.append({"frames": [src], "resize": t["size"], "out": outs[i],
                          "im_size": np.array([src.shape[:2]], np.float32)})
        else:
            calls.append({"images": src["images"], "im_size": src["im_size"], "out": outs[i]})
    del det, call, outs
    card.release(device)
    readings = compare.judge(ref, cfg, P, calls, device)

    images = len(lat) * t["batch"]
    return dict(
        e2e={"serve_img_per_s": (images / window_s, "img/s"),
             "serve_p95_ms": (p95_ms(lat), "ms")},
        setup_s=setup_s, device_name=card.name(device), attempted=len(lat), failed=failed,
        memory_peak=memory_peak, readings=readings, record=rec)
