#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ppyolo_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device   -- the card's name and count, and ``nvidia-smi``'s name and
               power limit (also printed raw on a line of its own).
2. build    -- builds every kernel from ``ppyolo_tpu_torch/csrc`` with nvcc
               (one process per source, in parallel) and prints the
               ``-Xptxas -v`` register / shared-memory summary.
3. kernels  -- each kernel at the shapes the ppyolo_2x@608 batch-8 serving
               path gives it, held against its plain PyTorch version on the
               same inputs on the card (max-abs error <= 2% of the plain
               output's max-abs: bf16 rounding of the operands), and timed
               with CUDA events over warm launches beside the plain version
               and the bound (989 TFLOP/s bf16, 3.35 TB/s).
4. serving  -- ppyolo_2x at full width (random weights from a seed) through
               the port's ``Detector``: BN folded, bf16, batch 8 at 608x608,
               decode and Matrix-NMS on the card.  The launch counters are
               zeroed just before and read just after; the kernels must have
               run 3 (DCN) and 1 (stem) times per batch.  Outputs must be
               finite [8,100,6], and the card's bf16 head maps must agree
               with the CPU path (the kernels' plain versions) on a small
               input.  Times 5 windows of 40 batches after 2 warm-up
               batches and prints img/s (all windows, and each window's for
               the spread) beside the card's name and power limit.
5. profile  -- device time by kernel (torch.profiler) over 3 more batches,
               the device's idle share, and the host's share of a batch.

Then one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL = 0.02                   # max-abs error / max-abs of the plain output
BATCH, SIZE = 8, 608
WARMUP_BATCHES = 2
WINDOWS, WINDOW_BATCHES = 5, 40   # timed serving: 200 batches, a few seconds


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, CUDA events over ``iters`` warm calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name: str, got, want) -> dict:
    err = float((got.float() - want.float()).abs().max())
    ref = float(want.float().abs().max())
    if not err <= TOL * ref:
        raise AssertionError(f"{name}: max-abs error {err} > {TOL} x {ref}")
    return {"max_abs_err": err, "max_abs_ref": ref}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    if not (REPO / "ppyolo_tpu_torch" / "csrc").is_dir():
        raise RuntimeError(f"{REPO} is not a checkout of the repository")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from ppyolo_tpu_torch.ops import _build

    t0 = time.time()
    _build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if any(w in ln for w in ("registers", "spill", "smem", "Compiling"))]
             for k, v in _build.PTXAS_REPORT.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas})


def dcn_inputs(gen, n, c, h, stride, dev):
    import torch

    oh = (h - 1) // stride + 1
    x = torch.randn(n, c, h, h, generator=gen).to(dev, torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=gen) * (2.0 / (c * 9 + c * 9)) ** 0.5
    off = torch.randn(n, 18, oh, oh, generator=gen) * 2.0
    off[:, 0, 0, 0] = 3.0 * h            # far out of range
    off[:, 1, -1, -1] = -3.0 * h
    off[:, 2, 1, :] = float(h)           # lands on the clamp edge
    msk = torch.randn(n, 9, oh, oh, generator=gen)
    om = torch.cat([off, msk], 1).to(dev, torch.bfloat16)
    cl = torch.channels_last
    return (x.contiguous(memory_format=cl), w.to(dev),
            om.contiguous(memory_format=cl), oh)


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes, timed."""
    import torch
    from ppyolo_tpu_torch.ops.deform_conv import deform_conv2d_plain
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd, pack_dcn_weight
    from ppyolo_tpu_torch.ops.stem import fused_stem, fused_stem_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # K1: stage5_0 (38x38, stride 2) once and stage5_1/5_2 (19x19) twice a batch
    shapes, k1 = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for h, stride, per_batch in ((38, 2, 1), (19, 1, 2)):
        x, w, om, oh = dcn_inputs(gen, BATCH, 512, h, stride, dev)
        packed = pack_dcn_weight(w)
        run_k = lambda: dcn_fwd(x, om, packed, None, ksize=(3, 3), stride=stride, padding=1)
        run_p = lambda: deform_conv2d_plain(x, w, om, stride=stride, padding=1)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        acc = check_close(f"dcn_fwd {h}x{h}/s{stride}", got, want)
        ms, pms = cuda_ms(run_k, 20), cuda_ms(run_p, 5)
        p = BATCH * oh * oh
        flops = 2.0 * p * 9 * 512 * 512
        nbytes = (x.numel() + om.numel() + packed.numel() + p * 512) * 2
        b, by = bound_ms(flops, nbytes)
        shapes.append({"x": [BATCH, h, h, 512], "stride": stride, "per_batch": per_batch,
                       "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
                       "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **acc})
        k1["ms"] += per_batch * ms
        k1["plain_ms"] += per_batch * pms
        k1["bound_ms"] += per_batch * b
        k1["max_abs_err"] = max(k1["max_abs_err"], acc["max_abs_err"])
        emit({"phase": "kernel_check", "kernel": "dcn_fwd", **shapes[-1]})
    rows["dcn_fwd"] = dict(
        name="dcn_fwd", route="cuda", source="ppyolo_tpu_torch/csrc/dcn_fwd.cu",
        replaces="ppyolo_tpu/ops/deform_conv_pallas.py:168", bound_by="operations",
        library_ms=None, per="batch of 8 (one 38x38/s2 + two 19x19/s1 launches)",
        shapes=shapes, **k1)

    # K2: [8, 608, 608, 3] bf16 -> [8, 152, 152, 64]
    x = torch.randn(BATCH, 3, SIZE, SIZE, generator=gen).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    ws = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        ws.append((torch.randn(cout, cin, 3, 3, generator=gen) * (2.0 / (cin * 9)) ** 0.5)
                  .to(dev, torch.bfloat16))
        ws.append((torch.randn(cout, generator=gen) * 0.1).to(dev))
    run_k = lambda: fused_stem(x, *ws)
    run_p = lambda: fused_stem_plain(x, *ws)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    acc = check_close("fused_stem", got, want)
    ms, pms = cuda_ms(run_k, 10), cuda_ms(run_p, 5)
    s2, s4 = SIZE // 2, SIZE // 4
    flops = 2.0 * BATCH * s2 * s2 * (27 * 32 + 288 * 32 + 288 * 64)
    nbytes = (x.numel() + BATCH * s4 * s4 * 64) * 2 + sum(t.numel() for t in ws) * 2
    b, by = bound_ms(flops, nbytes)
    emit({"phase": "kernel_check", "kernel": "fused_stem", "x": [BATCH, SIZE, SIZE, 3],
          "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
          "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **acc})
    rows["fused_stem"] = dict(
        name="fused_stem", route="cuda", source="ppyolo_tpu_torch/csrc/fused_stem.cu",
        replaces="ppyolo_tpu/ops/stem_pallas.py:314", ms=ms, plain_ms=pms,
        bound_ms=b, bound_by=by, library_ms=None, per="batch of 8 (one launch)",
        max_abs_err=acc["max_abs_err"])
    return rows


def build_model(cfg, device, calib_size=None):
    """ppyolo_2x on ``device`` with random weights from a seed: the JAX
    init's distributions and random offset-conv weights (fractional,
    spatially varying offsets).  With ``calib_size`` the BN statistics are
    then calibrated on one synthetic batch like the served ones, so the
    activations stay O(1) through the random network (the head's raw maps
    decode to finite boxes and real scores for Matrix-NMS); the variance
    floor keeps near-constant channels from amplifying small differences."""
    import numpy as np
    import torch
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.conv import ConvNormAct
    from ppyolo_tpu_torch.ops.module import BatchNorm

    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)

    def set_stats(bn, inp):
        v = inp[0].float()
        bn.running_mean.copy_(v.mean((0, 2, 3)))
        bn.running_var.copy_(v.var((0, 2, 3), unbiased=False).clamp_min(0.1))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNormAct) and m.use_dcn:
                off = m.conv.conv_offset
                off.bias.copy_(torch.randn(off.bias.shape, generator=gen))
                off.weight.copy_(torch.randn(off.weight.shape, generator=gen) * 1e-3)
        model.to(device)
        if calib_size is None:
            return model
        hooks = [m.register_forward_pre_hook(set_stats)
                 for m in model.modules() if isinstance(m, BatchNorm)]
        img = np.random.RandomState(1).randint(
            0, 256, (2, 3, calib_size, calib_size)).astype(np.float32)
        mean = np.array(cfg.normalizeImage["mean"], np.float32).reshape(1, 3, 1, 1)
        std = np.array(cfg.normalizeImage["std"], np.float32).reshape(1, 3, 1, 1)
        model.outputs(torch.from_numpy((img / 255.0 - mean) / std).to(device))
        for h in hooks:
            h.remove()
    return model


def phase_serving(smi: str):
    import numpy as np
    import torch
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd
    from ppyolo_tpu_torch.ops.stem import fused_stem

    cfg = PPYOLO_2x_Config()
    t0 = time.time()
    model = build_model(cfg, "cuda", SIZE)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    det = Detector(model, sd, cfg, precision="bf16", fold_bn=True, device="cuda")
    setup_s = time.time() - t0
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(2)]
    sizes = np.tile(np.array([[480, 640]], np.float32), (BATCH, 1))

    def serve(i):
        out = det.predict_batch(images[i % 2], sizes)   # ends in a D2H copy
        if out.shape != (BATCH, 100, 6) or not np.isfinite(out).all():
            raise AssertionError(f"batch {i}: bad output {out.shape}")
        return out

    dcn_fwd.launches = 0
    fused_stem.launches = 0
    torch.cuda.synchronize()
    for i in range(WARMUP_BATCHES):
        serve(i)
    lat, window_ips = [], []
    for _ in range(WINDOWS):
        tw = time.perf_counter()
        for i in range(WINDOW_BATCHES):
            t = time.perf_counter()
            out = serve(i)
            lat.append(time.perf_counter() - t)
        window_ips.append(BATCH * WINDOW_BATCHES / (time.perf_counter() - tw))
    n_batches = WARMUP_BATCHES + WINDOWS * WINDOW_BATCHES
    launches = {"dcn_fwd": dcn_fwd.launches, "fused_stem": fused_stem.launches}
    if launches != {"dcn_fwd": 3 * n_batches, "fused_stem": n_batches}:
        raise AssertionError(f"launch counts {launches} for {n_batches} batches")
    ips = BATCH * len(lat) / sum(lat)
    kept = int((out[..., 0] >= 0).sum())

    # the card path against the CPU path (the kernels' plain versions) on a
    # small input, with the init's identity BN: with calibrated BN the random
    # network is chaotic (its bf16 and fp32 CPU forwards differ by 0.4-0.9
    # relative L2), so there the check could not tell a fault from rounding
    x = np.ascontiguousarray(images[0][:2, 200:360, 200:360])
    maps = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, dev)
        d = Detector(m, {k: v.detach().cpu() for k, v in m.state_dict().items()}, cfg,
                     precision="bf16", device=dev)
        maps[dev] = [o.float().cpu() for o in d.model.outputs(
            d.normalize(torch.from_numpy(x).to(dev)))]
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(maps["cuda"], maps["cpu"])]
    if not all(r <= 2e-2 for r in rel):
        raise AssertionError(f"card vs CPU head maps, relative L2 {rel} > 2e-2")

    med = float(np.median(window_ips))
    result = {"phase": "serving", "model": "ppyolo_2x", "size": SIZE, "batch": BATCH,
              "precision": "bf16", "fold_bn": True, "batches": n_batches,
              "warmup_batches": WARMUP_BATCHES, "timed_batches": len(lat),
              "timed_s": sum(lat), "img_per_s": ips,
              "window_img_per_s": window_ips, "window_img_per_s_median": med,
              "window_spread": (max(window_ips) - min(window_ips)) / med,
              "batch_ms_median": 1e3 * float(np.median(lat)),
              "batch_ms_p90": 1e3 * float(np.percentile(lat, 90)),
              "batch_ms_min": 1e3 * min(lat), "setup_s": setup_s,
              "launches": launches, "kept_detections_last_batch": kept,
              "card_vs_cpu_rel_l2": rel, "nvidia_smi": smi,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return det, images[0], sizes, result["batch_ms_median"], launches


def phase_profile(det, images, sizes, batch_ms):
    """Device time by kernel over 3 steady batches (torch.profiler, CUDA
    activity only).  The idle share is taken against the unprofiled median
    batch time: the profiler's own host cost would inflate a profiled one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    det.predict_batch(images, sizes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            det.predict_batch(images, sizes)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in ev) / 1e3 / 3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:25]

    # host side of one batch: upload + normalize, enqueue of the forward
    # (returns before the card finishes), then the wait for the card
    import cProfile
    import io
    import pstats

    import numpy as np

    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        x = det.normalize(torch.from_numpy(images).to(det.device))
        s = torch.from_numpy(sizes).to(det.device)
        t1 = time.perf_counter()
        out = det.model.predict(x, s)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host.append((t1 - t0, t2 - t1, t3 - t2))
    upload_ms, enqueue_ms, wait_ms = (1e3 * float(np.median(c)) for c in zip(*host))
    pr = cProfile.Profile()
    pr.enable()
    det.model.predict(x, s)
    pr.disable()
    torch.cuda.synchronize()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(12)
    hot = [ln.strip() for ln in buf.getvalue().splitlines()
           if ln.strip() and ln.strip()[0].isdigit()][:12]
    del out
    emit({"phase": "profile", "batches": 3, "batch_ms_median": batch_ms,
          "device_ms_per_batch": total,
          "device_idle_share": max(0.0, 1.0 - total / batch_ms),
          "host_upload_normalize_ms": upload_ms, "host_enqueue_forward_ms": enqueue_ms,
          "host_wait_ms": wait_ms, "host_hot_functions": hot,
          "top": [{"name": e.key[:90], "ms_per_batch": e.self_device_time_total / 1e3 / 3,
                   "calls_per_batch": e.count / 3} for e in top]})


def main() -> int:
    try:
        import torch

        name, smi = phase_device()
        sys.path.insert(0, str(REPO))
        torch.backends.cudnn.allow_tf32 = False        # fp32 plain versions in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_build()
        rows = phase_kernels()
        det, images, sizes, batch_ms, launches = phase_serving(smi)
        phase_profile(det, images, sizes, batch_ms)
    except Exception as e:  # report and fail: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    for k, row in rows.items():
        row["launches"] = launches[k]
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
