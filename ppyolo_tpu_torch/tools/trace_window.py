"""Does a torch.profiler trace of served batches hold every kernel launched?

    python -m ppyolo_tpu_torch.tools.trace_window [--seconds 300] [--batch 8]
        [--size 608] [--leads none,0.005,0.05]

On the card only.  Serves ppyolo_2x (random weights from a seed, bf16, BN
folded) as CUDA graph replays and traces 3 batches a session, sessions
taken in turn for each lead: ``none`` is a bare ``torch.profiler.profile``
window, a number is ``utils/profiling.py::device_trace`` with that
``TRACE_LEAD_S``.  A session is complete when its trace holds as many
device records as the most that any session of the same work held, and it
agrees when the trace's K1 (``dcn_fwd_kernel``) and K2
(``fused_stem_kernel``) launches equal the wrappers' counters.  Each
session also reads the device clock against the host's: for each
``cudaGraphLaunch`` call, its first kernel's start minus the call's start
(negative only where the two clocks disagree), and the first launch's
distance from the window's opening.  Prints one JSON object a lead, and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _session(det, images, sizes, lead):
    from torch.profiler import ProfilerActivity, profile

    from ..ops.deform_conv_cuda import dcn_fwd
    from ..ops.stem import fused_stem
    from ..utils import profiling

    det.predict_batch(images[0], sizes)
    torch.cuda.synchronize()
    before = dcn_fwd.launches, fused_stem.launches
    default = profiling.TRACE_LEAD_S
    if lead is None:
        window = profile(activities=[ProfilerActivity.CUDA])
    else:
        profiling.TRACE_LEAD_S = lead
        window = profiling.device_trace()
    try:
        with window as prof:
            for i in range(3):
                det.predict_batch(images[i % len(images)], sizes)
            torch.cuda.synchronize()
    finally:
        profiling.TRACE_LEAD_S = default
    counted = [dcn_fwd.launches - before[0], fused_stem.launches - before[1]]
    results = prof.profiler.kineto_results
    events = results.events()
    device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    traced = [sum(1 for e in device if name in e.name())
              for name in ("dcn_fwd_kernel", "fused_stem_kernel")]
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != torch.autograd.DeviceType.CUDA and "GraphLaunch" in e.name()}
    first = {}
    for e in device:
        if e.correlation_id() in launch:
            first[e.correlation_id()] = min(first.get(e.correlation_id(), e.start_ns()),
                                            e.start_ns())
    return {"records": len(device), "agrees": traced == counted,
            "launch_to_kernel_us": [(first[c] - launch[c]) / 1e3 for c in first],
            "first_launch_us": (min(launch.values()) - results.trace_start_ns()) / 1e3}


def main(argv=None) -> dict:
    from configs import PPYOLO_2x_Config

    from ..eval.detector import Detector
    from ..models import PPYOLO

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=608)
    p.add_argument("--leads", default="none,0.005,0.05")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_window needs a CUDA card")
    leads = [None if x == "none" else float(x) for x in args.leads.split(",")]

    cfg = PPYOLO_2x_Config()
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), cfg, target_size=args.size, precision="bf16",
                   device="cuda")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
              for _ in range(3)]
    sizes = np.tile(np.array([[480, 640]], np.float32), (args.batch, 1))
    rows = {lead: [] for lead in leads}
    end = time.time() + args.seconds
    while time.time() < end:
        for lead in leads:
            rows[lead].append(_session(det, images, sizes, lead))
    full = max(r["records"] for rs in rows.values() for r in rs)
    out = {}
    for lead, rs in rows.items():
        offsets = [x for r in rs for x in r["launch_to_kernel_us"]]
        out["none" if lead is None else str(lead)] = row = {
            "sessions": len(rs), "records_complete": full,
            "incomplete": sum(r["records"] < full for r in rs),
            "disagree": sum(not r["agrees"] for r in rs),
            "launch_to_kernel_us_min": min(offsets), "launch_to_kernel_us_median":
                float(np.median(offsets)),
            "first_launch_us_min": min(r["first_launch_us"] for r in rs)}
        print(json.dumps({"lead_s": lead, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return out


if __name__ == "__main__":
    main()
