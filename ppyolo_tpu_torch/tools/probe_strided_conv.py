"""Measure the strided-3x3 implementations at the ppyolo_2x serving shapes.

Counterpart of ``tools/probe_strided_conv.py``.  stage3_0's conv2
[8,128,152,152] -> [8,128,76,76] and stage4_0's [8,256,76,76] ->
[8,256,38,38] (b8@608).  Each variant runs over ``scan`` distinct inputs,
never one loop-invariant batch: one warm pass, then device time from CUDA
events around ``disp`` passes, in ms per batch of 8.  The baseline runs
again last as drift control.  Before it is timed, each variant's output on
the first input is held against the plain version (max-abs error <= 2% of
its max-abs); a variant that fails is reported and counted, and the script
then exits non-zero.

Variants: ``conv2d`` (one ``F.conv2d`` call, cuDNN on the card),
``phase`` (K4's plain version), ``k4`` (``conv_s2``: the kernel on the
card, the plain version with ``--cpu``; the weight packed once per shape,
outside the timed passes), ``conv2d#2``.  Each shape's bound
is printed from the H100's peaks.  TF32 is off, so fp32 runs in fp32.

Usage: python -m ppyolo_tpu_torch.tools.probe_strided_conv
           [--batch 8] [--scan 32] [--disp 4] [--cpu] [--dtype bf16|fp32]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from ..ops.strided_conv import conv_s2, conv_s2_conv2d, conv_s2_phase, pack_conv_s2_weight

METRIC = "strided_conv_ab_ms_per_b8_batch"
SHAPES = [("stage3_0", 152, 128, 128), ("stage4_0", 76, 256, 256)]  # (name, H, C, Co)
# H100 SXM dense peaks: bf16 on the tensor cores, fp32 outside them; HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
TOL = 0.02


def bound_b8(h: int, c: int, co: int, dtype: str) -> dict:
    """Least time for one batch of 8 on the H100: the larger of the
    operations at the peak rate and each input read once plus the output
    written once at the memory rate."""
    n, s = 8, h // 2
    flops = 2.0 * n * s * s * 9 * c * co
    nbytes = (n * h * h * c + n * s * s * co + 9 * c * co) * (2 if dtype == "bf16" else 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def _ms_per_call(fn, xs, w, disp: int, dev: torch.device) -> float:
    def one_pass():
        for x in xs:
            fn(x, w)

    one_pass()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(disp):
            one_pass()
        end.record()
        torch.cuda.synchronize(dev)
        total = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(disp):
            one_pass()
        total = (time.perf_counter() - t0) * 1e3
    return total / (disp * len(xs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scan", type=int, default=32)
    ap.add_argument("--disp", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    a = ap.parse_args(argv)

    if a.cpu:
        dev, name = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: the probe runs on the card (--cpu for the plain path)")
        dev = torch.device("cuda")
        name = torch.cuda.get_device_name(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.bfloat16 if a.dtype == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device={name} b{a.batch} scan={a.scan} disp={a.disp} dtype={a.dtype}", flush=True)
    result = {"metric": METRIC}
    bounds, failed = {}, []
    for sname, h, c, co in SHAPES:
        xall = (torch.randn((a.scan, a.batch, h, h, c), generator=gen, device=dev) * 0.1).to(dt)
        xs = [xall[i].permute(0, 3, 1, 2) for i in range(a.scan)]   # channels_last views
        w = (torch.randn((co, c, 3, 3), generator=gen, device=dev) * 0.05).to(dt)
        b = bounds[sname] = bound_b8(h, c, co, a.dtype)
        print(f"{sname}: [{a.batch},{c},{h},{h}]->{co}  bound {b['bound_ms']:.4f} ms/b8 "
              f"({b['bound_by']}; {b['gflop']:.2f} GFLOP, {b['mbytes']:.1f} MB at b8; "
              f"H100 {PEAK_FLOPS[a.dtype] / 1e12:.0f} TFLOP/s, {PEAK_BYTES / 1e12} TB/s)",
              flush=True)
        want = conv_s2_phase(xs[0], w).float()
        packed = pack_conv_s2_weight(w, dt)
        variants = {"conv2d": conv_s2_conv2d, "phase": conv_s2_phase,
                    "k4": lambda x, w: conv_s2(x, w, packed=packed), "conv2d#2": conv_s2_conv2d}
        row = {}
        for vname, fn in variants.items():
            try:
                err = float((fn(xs[0], w).float() - want).abs().max())
                ref = float(want.abs().max())
                if not err <= TOL * ref:
                    raise AssertionError(f"max-abs error {err} > {TOL} x {ref} against the plain version")
                ms = _ms_per_call(fn, xs, w, a.disp, dev) * 8 / a.batch
            except Exception as e:  # reported and counted, never skipped
                traceback.print_exc()
                print(f"  {vname:<9} FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
                row[vname] = None
                failed.append(f"{sname}/{vname}")
                continue
            row[vname] = ms
            note = "  (the plain version: the input lies on the CPU)" \
                if vname == "k4" and dev.type == "cpu" else ""
            print(f"  {vname:<9} {ms:9.4f} ms/b8-batch  max-abs err {err:.3g}{note}", flush=True)
        result[sname] = row
    result.update(device=name, dtype=a.dtype, batch=a.batch, scan=a.scan, disp=a.disp,
                  bound_ms_per_b8=bounds, failed=failed)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
