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
3. kernels  -- each kernel at the shapes its path gives it (K1 and K2 at
               ppyolo_2x@608 batch-8 serving, K3 at the same model's
               training step, K4 at the probe's stage3_0 and stage4_0
               convs, b8 bf16), held against its plain PyTorch version on
               the same inputs on the card (max-abs error <= 2% of the
               plain output's max-abs: bf16 rounding of the operands, and
               for K3 fp32 sums in another order), and timed with CUDA
               events over warm launches beside the plain version and the
               bound (989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s); K4
               also beside one cuDNN ``F.conv2d`` call (``library_ms``).
               Weights are packed once, outside the timed window.  K1 and
               K3 are timed inside a CUDA graph of 20 calls
               (``kernel_ab.graph_ms``: their wrappers' host work outlasts
               their kernels; ``wrapper_ms`` is the eager time), L2-warm
               on one input and over
               DISTINCT_SETS input sets in turn (``ms_distinct``).  All
               report TFLOP/s (K3 also GB/s), the ratio to the bound (K4
               also to cuDNN) and the blocks per SM the occupancy API gives
               beside ptxas's registers and shared memory.
4. probe    -- the strided-conv probe's entry point
               (``ppyolo_tpu_torch.tools.probe_strided_conv.main``) at b8
               bf16 with a short scan: cuDNN, the plain version and K4 over
               distinct inputs.  Counters zeroed before and read after: K4
               launched, no other kernel; no variant failed.
5. serving  -- ppyolo_2x at full width (random weights from a seed) through
               the port's ``Detector``: BN folded, bf16, batch 8 at 608x608,
               decode and Matrix-NMS on the card, each batch one replay of
               a CUDA graph captured at the first batch.  The launch
               counters are zeroed just before and read just after: K1 3
               and K2 1 launches per batch, the graph's eager warm-up run
               and every replay counted (a graph adds the calls it recorded
               at capture to the counts at each replay), K3 and K4 never;
               one graph's calls recorded (``captured``).
               Outputs must be finite [8,100,6], and the card's bf16 head
               maps must agree with the CPU path (the kernels' plain
               versions) on a small input.  Times 5 windows of 40 batches
               after 2 warm-up batches and prints img/s (all windows, and
               each window's for the spread) beside the card's name and
               power limit.
6. profile  -- device time by kernel (torch.profiler) over 3 more graphed
               batches, K1 3 and K2 1 per batch counted from the kernel
               names in the trace and equal to the counters over the same
               batches, the device's idle share, and the host's share of
               an eager batch.
6b. graphs_serving -- the graphed ``predict_batch`` bit-equal to the eager
               forward on a b8@608 batch, again after ``set_params`` with
               other weights, and ``predict_pipelined(group=4)`` bit-equal
               to 4 ``predict_batch``; img/s, the host's enqueue ms per
               batch, device ms and idle share of eager, graphed and
               pipelined serving, K1 and K2 per batch from each trace (and
               the counters equal to each trace's).
7. training -- ppyolo_2x at full width and depth with ``freeze_at=0``
               (every stage trains, so the DCN backward runs), bf16 mixed
               precision, EMA and DropBlock on, batch 8 at 608x608 on
               seeded synthetic uint8 batches whose targets are built on the
               card, through the port's ``run_training`` (each step a CUDA
               graph replay): 2 warm-up steps, then 3 timed windows of 10
               steps.  Counters zeroed before and read after: K1 and K3 3
               launches each per step, the warm-up run's and every
               replay's, K2 and K4 never (training runs the unfused stem).  Logged losses
               finite, every trainable leaf moved, the EMA-applied state
               finite.
8. train_profile -- device time by kernel per graphed step over 3 more
               steps, K1 3 and K3 3 per step from the trace (the counters
               equal to it), and the device's idle share.
8b. graphs_training -- the same fine-tuning, cuDNN deterministic: 4 graphed
               steps against 4 eager steps from the same state and
               generator (losses, params, BN statistics, momentum, EMA,
               step and generator bitwise), ``make_multi_train_step`` with
               4 steps in each target pipeline bitwise equal to each other
               and to the 4 one-step replays; ms/step, enqueue ms, idle
               share of eager, one-step and 4-step replays, capture
               seconds and peak memory.
9. train_check -- one fp32 step (TF32 off) on the card against the same step
               on the CPU path (the kernels' plain versions) at 128x128,
               batch 2, DropBlock off: losses and stage 5's gradients.

10. entry  -- the training entry a user runs
               (``ppyolo_tpu_torch.entry.train.run_training``) on full
               ppyolo_2x as its recipe sets it (``freeze_at=5``, bf16, EMA,
               DropBlock, mixup, 5 loader threads, the 10 sizes from 320 to
               608, batch 8) with ``--scan_steps 4`` and ``warmup_shapes``
               (every size's 4-step graph captured before the loop, seconds
               each) over a synthetic COCO set (ENTRY_TRAIN train
               and ENTRY_VAL val jpgs at COCO-like sizes, 80 classes).
               First K1 and K2 are held against their plain versions (TOL)
               at every shape the entry gives them: K1 on the stage-5 grids
               of each of the 10 sizes (stride 2 on size/16, stride 1 on
               size/32) at batch 8, K1 and K2 at the eval's batch 4 at 608.
               Then ENTRY_STEPS steps, a checkpoint at the midpoint and a COCO
               eval at the end at 608, batch 4.  Counters zeroed before and
               read after: K1 3 a step and K1 3 and K2 1 an eval batch, over
               the steps, the eval batches and the eager warm-up run before
               each of the 11 captures, K3 and K4 never.
               The eval of the final params with ``scan_group`` 2 equals
               ``scan_group`` 1 (stats and detections), K1 3 and K2 1 an
               eval batch in its trace.  Prints the loader's own img/s (the
               recipe's 5 threads), step ms by input size, the files
               written, the 12 mAP stats (finite, in [-1, 1]) and eval
               img/s; STEADY_STEPS more steps on the state it left (one sync
               at the end, units of 4 as graph replays), fed by the live
               loader and by the same batches made beforehand, with device
               time by kernel class, K1 per step from the trace, the idle
               share of each, and the host's enqueue of a graphed unit and
               of an eager step; and the resume check (units of 4):
               RESUME_STEPS straight against half, ``resume_state`` and the
               rest (DropBlock off, cuDNN deterministic), bitwise or within
               twice the spread of two straight runs.

Then one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Imports nothing of JAX.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL = 0.02                   # max-abs error / max-abs of the plain output
DISTINCT_SETS = 8            # input sets rotated through for the L2-cold kernel times
BATCH, SIZE = 8, 608
WARMUP_BATCHES = 2
GROUP = 4                         # batches a predict_pipelined replay serves
SERVE_MODE_BATCHES = 40           # batches timed per serving mode
WINDOWS, WINDOW_BATCHES = 5, 40   # timed serving: 200 batches, a few seconds
TRAIN_WARMUP, TRAIN_WINDOWS, TRAIN_WINDOW_STEPS = 2, 3, 10
GRAPH_STEPS, GRAPH_TIMED_UNITS = 4, 3   # graphed vs eager fine-tuning steps
CHECK_SIZE, CHECK_BATCH = 128, 2  # card-vs-CPU training step
# stage 5 alone, card vs the CPU run that rounds as the kernels do: the
# card read 0.038 and 0.045 at 128 and 256 px, while the unrounded CPU path
# lies 0.13-0.14 from both; float32 sums in another order and the rare bf16
# rounding they flip account for the rest
STAGE5_TOL = 0.1
PROBE_ARGS = ["--batch", str(BATCH), "--scan", "8", "--disp", "2", "--dtype", "bf16"]
ENTRY_TRAIN, ENTRY_VAL = 64, 16  # synthetic COCO images of the entry phase
ENTRY_STEPS, ENTRY_EVAL_BATCH = 16, 4
ENTRY_SCAN = 4                   # the recipe's --scan_steps in the entry phase
ENTRY_SCAN_GROUP = 2             # the eval's scan_group, held against 1
LOADER_BATCHES = 8               # the loader alone, after one warm batch
STEADY_STEPS = 8                 # steady steps after the entry's run
RESUME_STEPS = 16                # the resume check: 8 + 8 against 16
# the path whose run gives each kernel's ``launches``
MAIN_PATH = {"dcn_fwd": "serving", "fused_stem": "serving", "dcn_bwd": "training",
             "conv_s2": "probe"}


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


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def wrappers() -> dict:
    """Each kernel's launch wrapper: ``launches`` counts its kernel's
    launches (a CUDA graph adds the calls it recorded at each replay),
    ``captured`` the calls recorded into graphs."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, dcn_fwd
    from ppyolo_tpu_torch.ops.stem import fused_stem
    from ppyolo_tpu_torch.ops.strided_conv import conv_s2

    return {"dcn_fwd": dcn_fwd, "dcn_bwd": dcn_bwd, "fused_stem": fused_stem,
            "conv_s2": conv_s2}


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = fn.captured = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def read_captured() -> dict:
    return {k: fn.captured for k, fn in wrappers().items()}


def expect(per_unit: dict, units: int) -> dict:
    """Every wrapper's count for ``units`` units that launch ``per_unit``."""
    return {k: per_unit.get(k, 0) * units for k in wrappers()}


def warmup_iters() -> int:
    """The eager runs before each capture (they launch; the capture does not)."""
    from ppyolo_tpu_torch.train.graphs import WARMUP_ITERS

    return WARMUP_ITERS


def check_counts_in_trace(prof, where: str) -> dict:
    """The wrappers' counts since ``zero_counts`` against the launches of
    each kernel in the trace ``prof`` of the same calls."""
    counted, traced = read_counts(), kernel_launches(prof, 1)
    if counted != traced:
        raise AssertionError(f"{where}: counted launches {counted}, the trace has {traced}")
    return counted


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
    ptxas = {k: ptxas_lines(v) for k, v in _build.PTXAS_REPORT.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas})


def occupancy(name: str, *args: int) -> dict:
    """The bf16 kernel's blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    exported by its library; ``args`` picks one of K3's two kernels) beside
    ptxas's registers and shared memory."""
    from ppyolo_tpu_torch.ops import _build

    fn = {"conv_s2": "conv_s2_bf16_blocks_per_sm", "fused_stem": "fused_stem_blocks_per_sm",
          "dcn_fwd": "dcn_fwd_blocks_per_sm", "dcn_bwd": "dcn_bwd_blocks_per_sm"}[name]
    blocks = getattr(_build.load(name), fn)(*args)
    if blocks <= 0:
        raise RuntimeError(f"{fn}: cudaError {-blocks}")
    return {"blocks_per_sm": blocks, "ptxas": ptxas_lines(_build.PTXAS_REPORT.get(name, ""))}


def ptxas_lines(report: str) -> list:
    return [ln.strip() for ln in report.splitlines()
            if any(w in ln for w in ("registers", "spill", "smem", "Compiling"))]


def rotating(calls):
    """One callable that runs ``calls`` in turn, a different one each call:
    timed over DISTINCT_SETS input sets that do not fit L2 together, it
    gives the time on inputs the kernel has not just read."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def dcn_inputs(gen, n, c, h, stride, dev):
    import torch

    oh = (h - 1) // stride + 1
    x = torch.randn(n, c, h, h, generator=gen).to(dev, torch.bfloat16)
    w = torch.randn(c, c, 3, 3, generator=gen) * (2.0 / (c * 9 + c * 9)) ** 0.5
    off = torch.randn(n, 18, oh, oh, generator=gen) * 2.0
    off[:, 0, 0, 0] = 3.0 * h            # far out of range
    off[:, 1, -1, -1] = -3.0 * h
    off[:, 2, 1, :] = float(h - stride + 1)  # tap 1, output row 1: raw y = H-1+pad
    off[:, 3, :, 0] = -1.0               # tap 1, output column 0: raw x = -pad
    msk = torch.randn(n, 9, oh, oh, generator=gen)
    om = torch.cat([off, msk], 1).to(dev, torch.bfloat16)
    cl = torch.channels_last
    return (x.contiguous(memory_format=cl), w.to(dev),
            om.contiguous(memory_format=cl), oh)


def stem_inputs(gen, n, size, dev):
    """A bf16 channels_last image batch, the three convs' folded bf16
    weights and fp32 biases, and their packing."""
    import torch
    from ppyolo_tpu_torch.ops.stem import pack_stem_params

    x = torch.randn(n, 3, size, size, generator=gen).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    ws = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        ws.append((torch.randn(cout, cin, 3, 3, generator=gen) * (2.0 / (cin * 9)) ** 0.5)
                  .to(dev, torch.bfloat16))
        ws.append((torch.randn(cout, generator=gen) * 0.1).to(dev))
    return x, ws, pack_stem_params(*ws)


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes, timed."""
    import torch
    from ppyolo_tpu_torch.ops.deform_conv import deform_conv2d_plain
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd, pack_dcn_weight
    from ppyolo_tpu_torch.ops.stem import fused_stem, fused_stem_plain
    from ppyolo_tpu_torch.tools.kernel_ab import graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # K1: stage5_0 (38x38, stride 2) once and stage5_1/5_2 (19x19) twice a batch
    shapes = []
    k1 = {"ms": 0.0, "ms_distinct": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "max_abs_err": 0.0}
    flops_batch = 0.0
    for h, stride, per_batch in ((38, 2, 1), (19, 1, 2)):
        x, w, om, oh = dcn_inputs(gen, BATCH, 512, h, stride, dev)
        packed = pack_dcn_weight(w)   # once, outside every timed window
        run_k = lambda: dcn_fwd(x, om, packed, None, ksize=(3, 3), stride=stride, padding=1)
        run_p = lambda: deform_conv2d_plain(x, w, om, stride=stride, padding=1)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        acc = check_close(f"dcn_fwd {h}x{h}/s{stride}", got, want)
        gen_d = torch.Generator().manual_seed(100 + h)   # leaves gen's sequence as it was
        sets = [dcn_inputs(gen_d, BATCH, 512, h, stride, dev) for _ in range(DISTINCT_SETS)]
        run_d = rotating([lambda s=s: dcn_fwd(s[0], s[2], packed, None, ksize=(3, 3),
                                              stride=stride, padding=1) for s in sets])
        ms, msd = graph_ms(run_k, 20), graph_ms(run_d, 3 * DISTINCT_SETS)
        wms, pms = cuda_ms(run_k, 20), cuda_ms(run_p, 5)
        del sets
        p = BATCH * oh * oh
        flops = 2.0 * p * 9 * 512 * 512
        nbytes = (x.numel() + om.numel() + packed.numel() + p * 512) * 2
        b, by = bound_ms(flops, nbytes)
        shapes.append({"x": [BATCH, h, h, 512], "stride": stride, "per_batch": per_batch,
                       "ms": ms, "ms_distinct": msd, "wrapper_ms": wms, "plain_ms": pms,
                       "bound_ms": b, "bound_by": by, "gflop": flops / 1e9,
                       "mbytes": nbytes / 1e6, "tflops": flops / ms / 1e9, "x_bound": ms / b,
                       **acc})
        for k, v in (("ms", ms), ("ms_distinct", msd), ("wrapper_ms", wms), ("plain_ms", pms),
                     ("bound_ms", b)):
            k1[k] += per_batch * v
        flops_batch += per_batch * flops
        k1["max_abs_err"] = max(k1["max_abs_err"], acc["max_abs_err"])
        emit({"phase": "kernel_check", "kernel": "dcn_fwd", **shapes[-1]})
    rows["dcn_fwd"] = dict(
        name="dcn_fwd", route="cuda", source="ppyolo_tpu_torch/csrc/dcn_fwd.cu",
        replaces="ppyolo_tpu/ops/deform_conv_pallas.py:168", bound_by="operations",
        library_ms=None, per="batch of 8 (one 38x38/s2 + two 19x19/s1 launches)",
        tflops=flops_batch / k1["ms"] / 1e9, x_bound=k1["ms"] / k1["bound_ms"],
        occupancy=occupancy("dcn_fwd"), shapes=shapes, **k1)

    # K2: [8, 608, 608, 3] bf16 -> [8, 152, 152, 64]
    x, ws, packed = stem_inputs(gen, BATCH, SIZE, dev)   # packed outside every timed window
    run_k = lambda: fused_stem(x, *ws, packed=packed)
    run_p = lambda: fused_stem_plain(x, *ws)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    acc = check_close("fused_stem", got, want)
    ms, pms = cuda_ms(run_k, 20), cuda_ms(run_p, 5)
    s2, s4 = SIZE // 2, SIZE // 4
    flops = 2.0 * BATCH * s2 * s2 * (27 * 32 + 288 * 32 + 288 * 64)
    nbytes = (x.numel() + BATCH * s4 * s4 * 64) * 2 + sum(t.numel() for t in ws) * 2
    b, by = bound_ms(flops, nbytes)
    stats = {"tflops": flops / ms / 1e9, "x_bound": ms / b, "occupancy": occupancy("fused_stem"),
             "warpgroups": ["conv1_3 on wgmma", "conv1_2 on wgmma, one conv1_1 tile, the pool",
                            "four conv1_1 tiles on mma.sync, the cp.async input loads"]}
    emit({"phase": "kernel_check", "kernel": "fused_stem", "x": [BATCH, SIZE, SIZE, 3],
          "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by,
          "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **stats, **acc})
    rows["fused_stem"] = dict(
        name="fused_stem", route="cuda", source="ppyolo_tpu_torch/csrc/fused_stem.cu",
        replaces="ppyolo_tpu/ops/stem_pallas.py:314", ms=ms, plain_ms=pms,
        bound_ms=b, bound_by=by, library_ms=None, per="batch of 8 (one launch)",
        max_abs_err=acc["max_abs_err"], **stats)
    rows["dcn_bwd"] = kernel_k3(gen, dev)
    rows["conv_s2"] = kernel_k4(gen, dev)
    return rows


def kernel_k4(gen, dev) -> dict:
    """K4 at the probe's b8 bf16 shapes (stage3_0 and stage4_0's strided
    3x3) against ``conv_s2_phase``, timed beside it and beside one cuDNN
    ``F.conv2d`` call on the same inputs."""
    import torch
    from ppyolo_tpu_torch.ops.strided_conv import (conv_s2, conv_s2_conv2d, conv_s2_phase,
                                                   pack_conv_s2_weight)
    from ppyolo_tpu_torch.tools.probe_strided_conv import SHAPES

    shapes = []
    k4 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    t_ops = t_bytes = flops_pair = 0.0
    for name, h, c, co in SHAPES:
        x = torch.randn(BATCH, h, h, c, generator=gen).to(dev, torch.bfloat16).permute(0, 3, 1, 2)
        w = (torch.randn(co, c, 3, 3, generator=gen) * (2.0 / (9 * c)) ** 0.5).to(dev, torch.bfloat16)
        packed = pack_conv_s2_weight(w)   # once, outside every timed window
        run_k = lambda: conv_s2(x, w, packed=packed)
        run_p = lambda: conv_s2_phase(x, w)
        run_l = lambda: conv_s2_conv2d(x, w)
        got, want, lib = run_k(), run_p(), run_l()
        torch.cuda.synchronize()
        acc = check_close(f"conv_s2 {name}", got, want)
        acc["library_max_abs_err"] = float((lib.float() - want.float()).abs().max())
        ms, pms, lms = cuda_ms(run_k, 20), cuda_ms(run_p, 5), cuda_ms(run_l, 20)
        s = h // 2
        flops = 2.0 * BATCH * s * s * 9 * c * co
        nbytes = (x.numel() + BATCH * s * s * co + w.numel()) * 2
        b, by = bound_ms(flops, nbytes)
        t_ops += flops / PEAK_BF16_FLOPS * 1e3
        t_bytes += nbytes / PEAK_BYTES * 1e3
        flops_pair += flops
        shapes.append({"conv": name, "x": [BATCH, h, h, c], "co": co, "ms": ms,
                       "plain_ms": pms, "library_ms": lms, "bound_ms": b, "bound_by": by,
                       "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                       "tflops": flops / ms / 1e9, "x_bound": ms / b, "x_library": ms / lms,
                       **acc})
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", b)):
            k4[k] += v
        k4["max_abs_err"] = max(k4["max_abs_err"], acc["max_abs_err"])
        emit({"phase": "kernel_check", "kernel": "conv_s2", **shapes[-1]})
    return dict(
        name="conv_s2", route="cuda", source="ppyolo_tpu_torch/csrc/conv_s2.cu",
        replaces="ppyolo_tpu/ops/strided_conv_pallas.py:100",
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        per="b8 pair (one stage3_0 + one stage4_0 launch; library: cuDNN F.conv2d)",
        tflops=flops_pair / k4["ms"] / 1e9, x_bound=k4["ms"] / k4["bound_ms"],
        x_library=k4["ms"] / k4["library_ms"], occupancy=occupancy("conv_s2"),
        shapes=shapes, **k4)


def phase_probe() -> tuple:
    """The probe's entry point at b8 bf16, short scan; the counts zeroed
    just before and read just after."""
    from ppyolo_tpu_torch.tools import probe_strided_conv

    zero_counts()
    summary = probe_strided_conv.main(PROBE_ARGS)
    launches = read_counts()
    emit({"phase": "probe", "args": PROBE_ARGS, "launches": launches, "summary": summary})
    if summary["failed"]:
        raise AssertionError(f"probe variants failed: {summary['failed']}")
    if launches["conv_s2"] == 0 or any(v for k, v in launches.items() if k != "conv_s2"):
        raise AssertionError(f"probe launch counts {launches}: K4 and only K4 must launch")
    return launches, read_captured()


def kernel_k3(gen, dev) -> dict:
    """K3 at the training step's shapes: stage5_0's DCN (38x38 in, stride 2)
    once and stage5_1/5_2's (19x19, stride 1) twice a step, bf16 as the
    bf16 step gives them.  dx, dW and d_om of the whole backward (K3 between
    the two products) against ``dcn_backward(plain=True)`` on the same
    inputs; K3 timed alone on the dm the backward computes, the whole
    backward and the plain version beside it."""
    import torch
    from ppyolo_tpu_torch.ops.deform_conv import dcn_backward
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, pack_dcn_weight
    from ppyolo_tpu_torch.tools.kernel_ab import graph_ms

    c = 512
    shapes = []
    k3 = {"ms": 0.0, "ms_distinct": 0.0, "wrapper_ms": 0.0, "backward_ms": 0.0, "plain_ms": 0.0,
          "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
    flops_step = bytes_step = 0.0
    for h, stride, per_step in ((38, 2, 1), (19, 1, 2)):
        x, w, om, oh = dcn_inputs(gen, BATCH, c, h, stride, dev)
        g = torch.randn(BATCH, c, oh, oh, generator=gen).to(dev, torch.bfloat16)
        g = g.contiguous(memory_format=torch.channels_last)
        run_b = lambda: dcn_backward(x, w, om, g, stride=stride, padding=1)
        run_p = lambda: dcn_backward(x, w, om, g, stride=stride, padding=1, plain=True)
        got, want = run_b(), run_p()
        torch.cuda.synchronize()
        acc = {}
        for name, a, b in zip(("dx", "dW", "d_om"), got, want):
            if a.dtype != b.dtype or a.shape != b.shape or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"dcn_bwd {h}x{h}/s{stride} {name}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
            acc[name] = check_close(f"dcn_bwd {h}x{h}/s{stride} {name}", a, b)
        packed = pack_dcn_weight(w)
        dm = g.permute(0, 2, 3, 1).reshape(-1, c) @ packed
        run_k = lambda: dcn_bwd(x, om, dm, ksize=(3, 3), stride=stride, padding=1)
        sets, gen_d = [], torch.Generator().manual_seed(200 + h)
        for _ in range(DISTINCT_SETS):
            xs, _, oms, _ = dcn_inputs(gen_d, BATCH, c, h, stride, dev)
            sets.append((xs, oms, torch.randn(dm.shape, generator=gen_d).to(dev, torch.bfloat16)))
        run_d = rotating([lambda s=s: dcn_bwd(*s, ksize=(3, 3), stride=stride, padding=1)
                          for s in sets])
        ms, msd = graph_ms(run_k, 20), graph_ms(run_d, 3 * DISTINCT_SETS)
        del sets
        wms, bms, pms = cuda_ms(run_k, 20), cuda_ms(run_b, 20), cuda_ms(run_p, 3)
        p = BATCH * oh * oh
        elems = p * 9 * c
        # per (pixel, tap, channel): bilinear sample 7, dmod 2, dsamp 1,
        # scatter 8, corner dots 8, column 1 -- fp32 on the CUDA cores
        flops = 27.0 * elems
        # each input read once (x, om, dm bf16), each output written once
        # (dx fp32, d_om bf16, cols bf16)
        nbytes = (x.numel() + om.numel() + elems) * 2 + x.numel() * 4 + (om.numel() + elems) * 2
        b, by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
        err = max(a["max_abs_err"] / max(a["max_abs_ref"], 1e-30) for a in acc.values())
        shapes.append({"x": [BATCH, h, h, c], "stride": stride, "per_step": per_step,
                       "ms": ms, "ms_distinct": msd, "wrapper_ms": wms, "backward_ms": bms,
                       "plain_ms": pms,
                       "bound_ms": b, "bound_by": by, "mflop": flops / 1e6,
                       "mbytes": nbytes / 1e6, "tflops": flops / ms / 1e9,
                       "gb_per_s": nbytes / ms / 1e6, "x_bound": ms / b,
                       "gemm_gflop_each": 2.0 * p * c * 9 * c / 1e9, "checks": acc})
        flops_step += per_step * flops
        bytes_step += per_step * nbytes
        k3["ms"] += per_step * ms
        k3["ms_distinct"] += per_step * msd
        k3["wrapper_ms"] += per_step * wms
        k3["backward_ms"] += per_step * bms
        k3["plain_ms"] += per_step * pms
        k3["bound_ms"] += per_step * b
        k3["max_abs_err"] = max(k3["max_abs_err"], max(a["max_abs_err"] for a in acc.values()))
        k3["max_rel_err"] = max(k3["max_rel_err"], err)
        emit({"phase": "kernel_check", "kernel": "dcn_bwd", **shapes[-1]})
    bound_by = {sh["bound_by"] for sh in shapes}
    return dict(
        name="dcn_bwd", route="cuda", source="ppyolo_tpu_torch/csrc/dcn_bwd.cu",
        replaces="ppyolo_tpu/ops/deform_conv_pallas.py:261",
        bound_by=bound_by.pop() if len(bound_by) == 1 else "mixed",
        library_ms=None, per="training step of 8 (one 38x38/s2 + two 19x19/s1 launches)",
        tflops=flops_step / k3["ms"] / 1e9, gb_per_s=bytes_step / k3["ms"] / 1e6,
        x_bound=k3["ms"] / k3["bound_ms"],
        occupancy={"main": occupancy("dcn_bwd", 0), "gather": occupancy("dcn_bwd", 1)},
        shapes=shapes, **k3)


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

    zero_counts()
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
    launches, captured = read_counts(), read_captured()
    # one CUDA graph (b8@608), captured at the first batch after its eager
    # warm-up run; every batch is a replay
    per_batch = {"dcn_fwd": 3, "fused_stem": 1}
    if (launches != expect(per_batch, n_batches + warmup_iters())
            or captured != expect(per_batch, 1)):
        raise AssertionError(f"launch counts {launches}, captured {captured}: want "
                             f"{per_batch} per batch and one captured graph")
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
              "launches": launches, "captured": captured,
              "kept_detections_last_batch": kept,
              "card_vs_cpu_rel_l2": rel, "nvidia_smi": smi,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return det, sd, images[0], sizes, result["batch_ms_median"], (launches, captured)


def kernel_launches(prof, units: int) -> dict:
    """Launches of each port kernel per unit, counted from the profiler's
    kernel names (inside CUDA graph replays too)."""
    names = {"dcn_fwd": ("dcn_fwd_kernel",), "dcn_bwd": ("dcn_bwd_kernel",),
             "fused_stem": ("fused_stem_kernel",), "conv_s2": ("conv_s2_",)}
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return {k: sum(e.count for e in ev if any(n in e.key for n in keys)) / units
            for k, keys in names.items()}


def phase_profile(det, images, sizes, batch_ms):
    """Device time by kernel over 3 steady graphed batches (torch.profiler,
    CUDA activity only), and each kernel's launches per batch read from its
    name in the trace.  The idle share is taken against the unprofiled
    median batch time: the profiler's own host cost would inflate a
    profiled one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    det.predict_batch(images, sizes)
    torch.cuda.synchronize()
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            det.predict_batch(images, sizes)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, "graphed serving")
    total, top, by_class = device_time(prof, 3)
    per_batch = kernel_launches(prof, 3)
    if per_batch != {"dcn_fwd": 3, "dcn_bwd": 0, "fused_stem": 1, "conv_s2": 0}:
        raise AssertionError(f"graphed serving: launches per batch {per_batch} in the trace")

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
          "device_ms_per_batch": total, "launches_per_batch": per_batch,
          "device_idle_share": max(0.0, 1.0 - total / batch_ms),
          "host_upload_normalize_ms": upload_ms, "host_enqueue_forward_ms": enqueue_ms,
          "host_wait_ms": wait_ms, "host_hot_functions": hot, "by_class": by_class,
          "top": top})


def eager_predict(det, pimages, sizes):
    """``predict_batch`` as it ran before the graphs: pinned upload,
    normalize and the model's forward, eagerly; returns (the detections on
    the card, the host's enqueue seconds)."""
    import torch

    t0 = time.perf_counter()
    x = torch.from_numpy(pimages).pin_memory().to(det.device, non_blocking=True)
    s = torch.from_numpy(sizes).pin_memory().to(det.device, non_blocking=True)
    with torch.no_grad():
        out = det.model.predict(det.normalize(x), s)
    return out, time.perf_counter() - t0


def serving_modes(det, batches, sizes) -> dict:
    """img/s, host enqueue ms and device idle share of a b8 batch served
    eagerly, as a graph replay (``predict_batch``) and four to a replay
    (``predict_pipelined(group=4)``), each over the same SERVE_MODE_BATCHES
    batches; device time per batch from the profiler over 4 more."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    big = np.concatenate(batches[:GROUP])
    big_sizes = np.concatenate([sizes] * GROUP)
    graphs = {g: det._graphs[g] for g in (1, GROUP)}

    def run(mode, i):
        if mode == "eager":
            out, enq = eager_predict(det, batches[i % GROUP], sizes)
            out.cpu()
            return enq, 1
        g = 1 if mode == "graphed" else GROUP
        ims, szs = (batches[i % GROUP], sizes) if g == 1 else (big, big_sizes)
        t0 = time.perf_counter()
        out = graphs[g]({"image": torch.from_numpy(ims).pin_memory(),
                         "im_size": torch.from_numpy(szs).pin_memory()})
        enq = time.perf_counter() - t0
        out["det"].cpu()
        return enq, g

    out = {}
    for mode in ("eager", "graphed", "pipelined"):
        for i in range(2):
            run(mode, i)
        torch.cuda.synchronize()
        enq, n, t0 = [], 0, time.perf_counter()
        while n < SERVE_MODE_BATCHES:
            e, g = run(mode, n)
            enq.append(e / g)
            n += g
        wall = time.perf_counter() - t0
        zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k = 0
            while k < GROUP:
                k += run(mode, k)[1]
            torch.cuda.synchronize()
        check_counts_in_trace(prof, f"{mode} serving")
        device_ms = device_time(prof, GROUP)[0]
        batch_ms = 1e3 * wall / n
        out[mode] = {"batches": n, "img_per_s": BATCH * n / wall, "batch_ms": batch_ms,
                     "enqueue_ms_per_batch": 1e3 * float(np.median(enq)),
                     "device_ms_per_batch": device_ms,
                     "device_idle_share": max(0.0, 1.0 - device_ms / batch_ms),
                     "launches_per_batch": kernel_launches(prof, GROUP)}
    return out


def phase_graphs_serving(det, sd, smi: str) -> dict:
    """The serving graphs against the eager forward on b8@608 bf16 batches:
    graphed ``predict_batch`` bit-equal to the eager forward; again after
    ``set_params`` with other weights (the packed DCN weights, the folded
    stem and the BN affines are refreshed in place, and the graph reads
    them); ``predict_pipelined(group=4)`` bit-equal to 4 ``predict_batch``;
    K1 3 and K2 1 per batch in the trace of every mode; then img/s, enqueue
    ms and idle share of each mode."""
    import numpy as np
    import torch

    rng = np.random.RandomState(11)
    batches = [rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
               for _ in range(GROUP)]
    sizes = np.tile(np.array([[480, 640], [608, 608]], np.float32), (BATCH // 2, 1))

    def equal_to_eager(tag):
        got = det.predict_batch(batches[0], sizes)
        want = eager_predict(det, batches[0], sizes)[0].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"graphed vs eager detections differ ({tag}): max abs "
                                 f"{float(np.abs(got - want).max())}")
        return got

    first = equal_to_eager("weights of the serving phase")
    g = torch.Generator().manual_seed(12)
    other = {k: (v * (1 + 0.05 * torch.randn(v.shape, generator=g))
                 if k.endswith("weight") and v.dim() == 4 else v) for k, v in sd.items()}
    det.set_params(other)
    second = equal_to_eager("after set_params")
    det.set_params(sd)
    back = det.predict_batch(batches[0], sizes)
    if np.array_equal(first, second) or not np.array_equal(first, back):
        raise AssertionError("set_params did not reach the graph's weights")
    piped = det.predict_pipelined(np.concatenate(batches), np.concatenate([sizes] * GROUP),
                                  group=GROUP)
    single = np.concatenate([det.predict_batch(b, sizes) for b in batches])
    if not np.array_equal(piped, single):
        raise AssertionError("predict_pipelined differs from predict_batch")
    modes = serving_modes(det, batches, sizes)
    for mode, r in modes.items():
        if r["launches_per_batch"] != {"dcn_fwd": 3, "dcn_bwd": 0, "fused_stem": 1,
                                       "conv_s2": 0}:
            raise AssertionError(f"{mode}: launches per batch {r['launches_per_batch']}")
    out = {"phase": "graphs_serving", "model": "ppyolo_2x", "size": SIZE, "batch": BATCH,
           "precision": "bf16", "group": GROUP, "bitwise_graphed_vs_eager": True,
           "bitwise_after_set_params": True, "bitwise_pipelined_vs_batches": True,
           "kept_detections": int((first[..., 0] >= 0).sum()),
           "capture_s": {str(k): sum(gr.captures.values()) for k, gr in det._graphs.items()},
           "modes": modes, "nvidia_smi": smi,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


KERNEL_CLASSES = (   # (class, substrings of the kernel name), first match wins
    ("port_kernels", ("dcn_fwd_kernel", "dcn_bwd_kernel", "dcn_bwd_gather",
                      "fused_stem_kernel", "conv_s2_")),
    ("conv_gemm", ("xmma", "nvjet", "cutlass", "gemm", "cudnn", "dgrad", "wgrad")),
    ("copy_memset", ("Memcpy", "Memset", "copy_kernel", "CatArray")),
    ("elementwise_reduce", ("at::native",)),
)


def device_time(prof, units: int, n_top: int = 25):
    """(device ms per unit, the n_top kernels by device time per unit, ms
    per unit by KERNEL_CLASSES) of a torch.profiler run over ``units``
    batches or steps."""
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in ev) / 1e3 / units
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:n_top]
    by_class = {}
    for e in ev:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3 / units
    return total, [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3 / units,
                    "calls": e.count / units} for e in top], by_class


def train_config():
    """ppyolo_2x fine-tuning with every stage trainable (``freeze_at=0``,
    docs/DESIGN.md "freeze_at=0 fine-tuning"), bf16 mixed precision, the
    recipe's EMA, DropBlock, LR schedule and SGD, as tools/bench_train.py
    runs it with ``--freeze 0``."""
    from configs import PPYOLO_2x_Config

    cfg = PPYOLO_2x_Config()
    cfg.backbone = dict(cfg.backbone, freeze_at=0)
    cfg.train_cfg = dict(cfg.train_cfg, batch_size=BATCH, precision="bf16",
                         log_iter=TRAIN_WINDOW_STEPS)
    return cfg


def synthetic_train_batch(cfg, seed: int, batch: int, size: int) -> dict:
    """One host batch as tools/bench_train.py makes it (lines 76-100): uint8
    images, 8 gt boxes of 50 padded slots per image; targets are built on
    the card from gt_class / gt_score."""
    import numpy as np

    r = np.random.RandomState(seed)
    m = 50
    gt_bbox = np.zeros((batch, m, 4), np.float32)
    gt_bbox[:, :8, 0:2] = r.uniform(0.2, 0.8, (batch, 8, 2))
    gt_bbox[:, :8, 2:4] = r.uniform(0.05, 0.4, (batch, 8, 2))
    gt_class = r.randint(0, cfg.num_classes, (batch, m)).astype(np.int32)
    gt_score = np.zeros((batch, m), np.float32)
    gt_score[:, :8] = 1.0
    return {"image": r.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
            "gt_bbox": gt_bbox, "gt_class": gt_class, "gt_score": gt_score}


def phase_training(smi: str):
    """The training path through ``run_training``; windows are timed by
    ``after_step``, which synchronizes at each window's edge."""
    import numpy as np
    import torch
    from ppyolo_tpu_torch.train.loop import run_training

    cfg = train_config()
    t0 = time.time()
    model = build_model(cfg, "cuda")
    before = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
    host = [synthetic_train_batch(cfg, seed, BATCH, SIZE) for seed in (0, 1)]
    setup_s = time.time() - t0
    n_steps = TRAIN_WARMUP + TRAIN_WINDOWS * TRAIN_WINDOW_STEPS
    edges = []

    def mark(st):   # after the warm-up steps and after each window
        j = st.step - TRAIN_WARMUP
        if j >= 0 and j % TRAIN_WINDOW_STEPS == 0:
            torch.cuda.synchronize()
            edges.append(time.perf_counter())

    logged = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, eval_sd = run_training(cfg, (host[i % 2] for i in range(n_steps)), device="cuda",
                                  max_iters=n_steps, model=model, after_step=mark,
                                  log_fn=lambda i, v: logged.append((i, v)))
    torch.cuda.synchronize()
    launches, captured = read_counts(), read_captured()
    # one CUDA graph (b8@608), captured at the first step after its eager
    # warm-up run; every step is a replay
    per_step = {"dcn_fwd": 3, "dcn_bwd": 3}
    if (launches != expect(per_step, n_steps + warmup_iters())
            or captured != expect(per_step, 1)):
        raise AssertionError(f"training launch counts {launches}, captured {captured}: "
                             f"want {per_step} per step and one captured graph")
    if state.step != n_steps or len(edges) != TRAIN_WINDOWS + 1:
        raise AssertionError(f"took {state.step} steps, {len(edges)} window edges")
    if len(logged) != n_steps // TRAIN_WINDOW_STEPS or not all(
            np.isfinite(v) for _, d in logged for v in d.values()):
        raise AssertionError(f"logged losses {logged}")
    params = dict(model.named_parameters())
    frozen = [k for k in state.trainable if torch.equal(before[k], params[k].detach())]
    if set(state.trainable) != set(before) or frozen:
        raise AssertionError(f"{len(frozen)} trainable leaves did not move: {frozen[:8]}")
    bad = [k for k, v in eval_sd.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"non-finite EMA-applied leaves {bad[:8]}")
    step_ms = [1e3 * (b - a) / TRAIN_WINDOW_STEPS for a, b in zip(edges, edges[1:])]
    med = float(np.median(step_ms))
    ips = [BATCH / (t / 1e3) for t in step_ms]
    result = {"phase": "training", "model": "ppyolo_2x", "freeze_at": 0, "size": SIZE,
              "batch": BATCH, "precision": "bf16", "ema": True, "drop_block": True,
              "steps": n_steps, "warmup_steps": TRAIN_WARMUP,
              "window_steps": TRAIN_WINDOW_STEPS, "window_ms_per_step": step_ms,
              "ms_per_step_median": med, "img_per_s": BATCH / (med / 1e3),
              "window_img_per_s": ips,
              "window_spread": (max(step_ms) - min(step_ms)) / med,
              "setup_s": setup_s, "launches": launches, "captured": captured,
              "trainable_leaves": len(state.trainable), "leaves_moved": len(state.trainable),
              "logged_losses": logged, "nvidia_smi": smi,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return state, cfg, host, med, (launches, captured)


def phase_train_profile(state, cfg, host, step_ms: float):
    """Device time by kernel per step over 3 graphed steps of the same loop
    body (H2D of the batch, the replay), K1 and K3 per step from the
    trace, and the idle share against the unprofiled median step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.train.loop import make_unit_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    step_fn = make_unit_step(state.model, cfg, state, gen, compute_dtype=torch.bfloat16)
    state, _ = step_fn(state, host_to_device(host[0], dev), gen)
    torch.cuda.synchronize()
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            state, _ = step_fn(state, host_to_device(host[i % 2], dev), gen)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, "graphed fine-tuning")
    total, top, by_class = device_time(prof, 3, 30)
    per_step = kernel_launches(prof, 3)
    if per_step != {"dcn_fwd": 3, "dcn_bwd": 3, "fused_stem": 0, "conv_s2": 0}:
        raise AssertionError(f"graphed fine-tuning: launches per step {per_step} in the trace")
    ours = {k: sum(e.self_device_time_total for e in prof.key_averages() if k in e.key) / 3e3
            for k in ("dcn_fwd_kernel", "dcn_bwd_kernel", "dcn_bwd_gather")}
    emit({"phase": "train_profile", "steps": 3, "ms_per_step_median": step_ms,
          "device_ms_per_step": total, "launches_per_step": per_step, "device_idle_share": max(0.0, 1.0 - total / step_ms),
          "kernel_ms_per_step": ours, "by_class": by_class, "top": top})


def tensors_diff(got: dict, want: dict) -> dict:
    """Leaves that differ between two ``TrainState.tensors()`` snapshots,
    and the largest absolute difference among them."""
    import torch

    bad = [k for k in want if not torch.equal(got[k], want[k])]
    worst = max((float((got[k].double() - want[k].double()).abs().max()) for k in bad),
                default=0.0)
    return {"leaves_differ": len(bad), "first": bad[:5], "max_abs": worst}


def phase_graphs_training(smi: str) -> dict:
    """Fine-tuning (``freeze_at=0``, b8@608 bf16, DropBlock, EMA; K1 and K3
    inside) as CUDA graphs against eager steps, cuDNN deterministic:

    1. GRAPH_STEPS graphed one-step replays against as many eager steps from
       the same state and generator: losses, params, BN statistics,
       momentum, EMA and the step bitwise equal;
    2. ``make_multi_train_step(n_steps=GRAPH_STEPS)`` in each target
       pipeline, one replay each from the same start: bitwise equal to each
       other and to the one-step replays;
    3. ms/step, host enqueue ms and the idle share of eager steps, one-step
       replays and multi-step replays; K1 and K3 per step from the trace;
       capture seconds and the peak memory of the graphs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import (TARGET_PIPELINES, init_train_state,
                                                   make_multi_train_step, make_train_step)

    dev = torch.device("cuda")
    cfg = train_config()
    bench, det = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        host = [synthetic_train_batch(cfg, 20 + i, BATCH, SIZE) for i in range(GRAPH_STEPS)]
        batches = [host_to_device(b, dev) for b in host]
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        states, gens = [], []
        for _ in range(2):
            model = build_model(cfg, "cuda").to(memory_format=torch.channels_last)
            states.append(init_train_state(model, cfg))
            gens.append(torch.Generator(device=dev).manual_seed(21))
        eager_state, graph_state = states
        start = {k: v.clone() for k, v in graph_state.tensors().items()}
        gen_start = gens[1].get_state()
        eager = make_train_step(eager_state.model, cfg, compute_dtype=torch.bfloat16)
        want = []
        for b in batches:
            want.append({k: v.clone() for k, v in eager(eager_state, b, gens[0])[1].items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one = GraphedStep(make_train_step(graph_state.model, cfg, compute_dtype=torch.bfloat16),
                          graph_state, gens[1])
        for i, b in enumerate(batches):
            losses = one(graph_state, b)[1]
            bad = [k for k, v in want[i].items() if not torch.equal(losses[k], v)]
            if bad:
                raise AssertionError(f"graphed step {i}: losses {bad} differ from eager: "
                                     f"{[(float(losses[k]), float(want[i][k])) for k in bad]}")
        diff = tensors_diff(graph_state.tensors(), eager_state.tensors())
        if diff["leaves_differ"] or not torch.equal(gens[1].get_state(), gens[0].get_state()):
            raise AssertionError(f"graphed vs eager state after {GRAPH_STEPS} steps: {diff}")
        one_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        after_one = {k: v.clone() for k, v in graph_state.tensors().items()}
        del eager_state, states

        def restart():
            with torch.no_grad():
                for k, v in graph_state.tensors().items():
                    v.copy_(start[k])
            gens[1].set_state(gen_start)
            graph_state.step = 0

        multi, multi_capture = {}, {}
        for mode in TARGET_PIPELINES:
            restart()
            unit = GraphedStep(make_multi_train_step(graph_state.model, cfg, n_steps=GRAPH_STEPS,
                                                     compute_dtype=torch.bfloat16,
                                                     target_pipeline=mode),
                               graph_state, gens[1], n_steps=GRAPH_STEPS)
            losses = unit(graph_state, stacked)[1]
            for k, v in losses.items():
                if not torch.equal(v, torch.stack([w[k] for w in want])):
                    raise AssertionError(f"{mode}: stacked losses {k} differ from the steps'")
            d = tensors_diff(graph_state.tensors(), after_one)
            if d["leaves_differ"]:
                raise AssertionError(f"{mode}: state after one {GRAPH_STEPS}-step replay "
                                     f"differs from {GRAPH_STEPS} one-step replays: {d}")
            multi_capture[mode] = sum(unit.graphs.captures.values())
            multi[mode] = unit   # every graph lives to the end of the phase
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # speed of the three forms on the same batches
        eager_fn = make_train_step(graph_state.model, cfg, compute_dtype=torch.bfloat16)
        forms = {"eager": lambda: [eager_fn(graph_state, b, gens[1]) for b in batches],
                 "graphed": lambda: [one(graph_state, b) for b in batches],
                 "multi": lambda: multi["step"](graph_state, stacked)}
        speed = {}
        for name, run in forms.items():
            run()
            torch.cuda.synchronize()
            enq = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                enq.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_TIMED_UNITS):
                run()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / (GRAPH_TIMED_UNITS * GRAPH_STEPS)
            zero_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            check_counts_in_trace(prof, f"{name} fine-tuning")
            device_ms = device_time(prof, GRAPH_STEPS)[0]
            speed[name] = {"ms_per_step": ms,
                           "enqueue_ms_per_step": 1e3 * float(np.median(enq)) / GRAPH_STEPS,
                           "device_ms_per_step": device_ms,
                           "device_idle_share": max(0.0, 1.0 - device_ms / ms),
                           "launches_per_step": kernel_launches(prof, GRAPH_STEPS)}
            if speed[name]["launches_per_step"] != {"dcn_fwd": 3, "dcn_bwd": 3, "fused_stem": 0,
                                                    "conv_s2": 0}:
                raise AssertionError(f"{name}: launches per step "
                                     f"{speed[name]['launches_per_step']}")
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
    out = {"phase": "graphs_training", "model": "ppyolo_2x", "freeze_at": 0, "size": SIZE,
           "batch": BATCH, "precision": "bf16", "steps": GRAPH_STEPS,
           "bitwise_graphed_vs_eager": True, "bitwise_pipelines": list(TARGET_PIPELINES),
           "capture_s_one_step": sum(one.graphs.captures.values()),
           "capture_s_multi": multi_capture, "peak_memory_gb_one_step_graph": one_peak_gb,
           "peak_memory_gb_with_multi_graphs": peak_gb, "speed": speed, "nvidia_smi": smi}
    emit(out)
    return out


def phase_train_check():
    """The card's training gradients against the CPU path (the kernels'
    plain versions), fp32 with TF32 off, from the same weights.

    1. One train step at CHECK_SIZE, DropBlock off (the two devices'
       generators differ): losses within 2e-3 relative L2.  Stage 5's
       gradients in that step are held only loosely: this random network's
       train-mode backward amplifies any rounding, so a third run on the
       CPU that rounds the DCN's operands to bf16 as K1 and K3 do
       (``operand_dtype``) measures the spread that rounding alone makes,
       and the card may lie no farther from the CPU path than twice that.
    2. Stage 5 alone (the three blocks that hold the DCNs, full width) from
       one seeded input and output cotangent, where the backward is well
       conditioned: its parameter and input gradients on the card within
       STAGE5_TOL relative L2 of the CPU run that rounds as the kernels
       do.  A gradient that is wrong in form, or missing, lies far
       farther."""
    import contextlib

    import numpy as np
    import torch
    from ppyolo_tpu_torch.ops import conv as conv_mod
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.ops.deform_conv import DeformConv2dFunction
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    cl = torch.channels_last
    cfg = train_config()
    cfg.head = dict(cfg.head, drop_block=False)
    host = synthetic_train_batch(cfg, 3, CHECK_BATCH, CHECK_SIZE)
    r = np.random.RandomState(5)
    s5 = CHECK_SIZE // 16   # stage 5's input side at CHECK_SIZE
    x5 = torch.from_numpy(np.maximum(r.randn(CHECK_BATCH, 1024, s5, s5), 0).astype(np.float32))
    cot5 = torch.from_numpy(r.randn(CHECK_BATCH, 2048, s5 // 2, s5 // 2).astype(np.float32))

    @contextlib.contextmanager
    def dcn_rounding(emulate):
        """With ``emulate``, the CPU path's DCN rounds its operands as the
        kernels do."""
        orig = conv_mod.deform_conv2d
        if emulate:
            conv_mod.deform_conv2d = (
                lambda x, w, om, *, stride, padding, packed_weight=None, bias=None:
                DeformConv2dFunction.apply(x, w, om, stride, padding, torch.bfloat16))
        try:
            yield
        finally:
            conv_mod.deform_conv2d = orig

    def stage5_grads(model):
        return [p.grad.detach().double().cpu().flatten()
                for k, p in model.named_parameters() if k.startswith("backbone.stage5")]

    def one_step(dev, emulate=False):
        """The step's losses and stage 5's gradients (read by hooks: the
        step takes its gradients with ``torch.autograd.grad``)."""
        model = build_model(cfg, dev).to(memory_format=cl)
        state = init_train_state(model, cfg)
        grads = {}
        s5 = [(k, p) for k, p in model.named_parameters() if k.startswith("backbone.stage5")]
        hooks = [p.register_hook(lambda g, k=k: grads.__setitem__(k, g)) for k, p in s5]
        with dcn_rounding(emulate):
            _, losses = make_train_step(model, cfg)(state, host_to_device(host, torch.device(dev)))
        for h in hooks:
            h.remove()
        lv = torch.tensor([float(v) for k, v in losses.items() if k != "lr"], dtype=torch.float64)
        return lv, torch.cat([grads[k].detach().double().cpu().flatten() for k, _ in s5])

    def stage5_alone(dev, emulate=False):
        model = build_model(cfg, dev).to(memory_format=cl).train()
        x = x5.to(dev).contiguous(memory_format=cl).requires_grad_()
        with dcn_rounding(emulate):
            y = x
            for name in ("stage5_0", "stage5_1", "stage5_2"):
                y = getattr(model.backbone, name)(y)
            (y * cot5.to(dev)).sum().backward()
        return (y.detach().double().cpu().flatten(),
                torch.cat([x.grad.double().cpu().flatten()] + stage5_grads(model)))

    runs = {"card": (*one_step("cuda"), *stage5_alone("cuda")),
            "cpu": (*one_step("cpu"), *stage5_alone("cpu")),
            "cpu_bf16_dcn": (*one_step("cpu", True), *stage5_alone("cpu", True))}

    def rel(a, b, i):
        return float((runs[a][i] - runs[b][i]).norm() / runs[b][i].norm())

    out = {f"{what}_{a}_vs_{b}": rel(a, b, i)
           for i, what in ((0, "losses"), (1, "stage5_grads"), (2, "stage5_alone_out"),
                           (3, "stage5_alone_grads"))
           for a, b in (("card", "cpu"), ("cpu_bf16_dcn", "cpu"), ("card", "cpu_bf16_dcn"))}
    finite = all(bool(torch.isfinite(v).all()) for r in runs.values() for v in r)
    emit({"phase": "train_check", "size": CHECK_SIZE, "batch": CHECK_BATCH,
          "precision": "fp32", "tf32": False, "finite": finite, **out})
    if not finite:
        raise AssertionError("non-finite losses or gradients in the train check")
    if out["losses_card_vs_cpu"] > 2e-3:
        raise AssertionError(f"card vs CPU losses: relative L2 {out['losses_card_vs_cpu']} > 2e-3")
    spread = out["stage5_grads_cpu_bf16_dcn_vs_cpu"]
    if out["stage5_grads_card_vs_cpu"] > 2.0 * spread:
        raise AssertionError(f"card vs CPU stage-5 gradients: relative L2 "
                             f"{out['stage5_grads_card_vs_cpu']} > 2 x {spread}")
    got = out["stage5_alone_grads_card_vs_cpu_bf16_dcn"]
    if got > STAGE5_TOL:
        raise AssertionError(f"stage 5 alone, card vs CPU with the kernels' rounding: "
                             f"relative L2 of the gradients {got} > {STAGE5_TOL}")


def entry_dataset(root: Path) -> dict:
    """The synthetic COCO sets of the entry phase: ENTRY_TRAIN train and
    ENTRY_VAL val jpgs at COCO-like sizes, 80 classes, 1-6 boxes each."""
    import numpy as np
    from ppyolo_tpu_torch.data.synthetic import make_synthetic_coco

    kw = dict(image_sizes=((480, 640), (640, 480), (427, 640), (640, 427), (512, 512)),
              max_objects=6, box_range=(32, 224))
    train = make_synthetic_coco(str(root / "train"), ENTRY_TRAIN, 80, np.random.RandomState(0), **kw)
    val = make_synthetic_coco(str(root / "val"), ENTRY_VAL, 80, np.random.RandomState(1), **kw)
    return {"train": train, "val": val}


def entry_config(data: dict, root: Path, **train):
    """ppyolo_2x as its recipe trains it (``freeze_at=5``, EMA, DropBlock,
    mixup, 5 loader threads, the 10 sizes from 320 to 608, batch 8), bf16,
    on the synthetic sets; ``train`` overrides ``train_cfg``."""
    from configs import PPYOLO_2x_Config

    cfg = PPYOLO_2x_Config()
    cfg.train_path, cfg.train_pre_path = data["train"]
    cfg.val_path, cfg.val_pre_path = data["val"]
    cfg.classes_path = str(root / "no_classes.txt")
    cfg.train_cfg = dict(cfg.train_cfg, **dict(dict(
        batch_size=BATCH, precision="bf16", max_iters=ENTRY_STEPS, save_iter=ENTRY_STEPS // 2,
        eval_iter=ENTRY_STEPS, log_iter=1, model_path=str(root / "missing.npz")), **train))
    cfg.eval_cfg = dict(cfg.eval_cfg, eval_batch_size=ENTRY_EVAL_BATCH)
    return cfg


def read_metrics(wdir: Path):
    import json

    rows = [json.loads(line) for line in open(wdir / "metrics.jsonl")]
    return [r for r in rows if "total_loss" in r], [r for r in rows if "box_ap" in r]


def state_arrays(state) -> dict:
    """Every tensor of a train state the resume must restore, on the host."""
    out = {f"params/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"velocity/{k}": v for k, v in state.velocity().items()})
    out.update({f"ema/{k}": v for k, v in state.ema.items()})
    return {k: v.detach().double().cpu() for k, v in out.items()}


def state_diff(a: dict, b: dict) -> dict:
    """Max abs difference and relative L2 over all leaves, and the count of
    leaves that differ."""
    import torch

    num = den = 0.0
    worst, n_diff = 0.0, 0
    for k in a:
        d = a[k] - b[k]
        worst = max(worst, float(d.abs().max())) if d.numel() else worst
        n_diff += int(not torch.equal(a[k], b[k]))
        num += float(d.square().sum())
        den += float(b[k].square().sum())
    return {"max_abs": worst, "rel_l2": (num / max(den, 1e-300)) ** 0.5, "leaves_differ": n_diff}


def phase_entry(smi: str):
    """The training entry (``entry/train.py::run_training``) end to end on
    full ppyolo_2x: COCO loader, multi-scale bf16 steps, checkpoints, the
    periodic COCO eval; the loader alone; steady steps on the state it
    left, with and without the live loader; the resume check under
    deterministic cuDNN."""
    import os
    import shutil
    import statistics

    import numpy as np
    import torch
    from ppyolo_tpu_torch import native
    from ppyolo_tpu_torch.data.coco import CocoJson, category_maps, data_clean
    from ppyolo_tpu_torch.data.loader import train_batches
    from ppyolo_tpu_torch.entry.train import run_training

    root = REPO / "build" / "chip_smoke_entry"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.time()
    data = entry_dataset(root)
    lib = native.get_lib()
    out = {"phase": "entry", "model": "ppyolo_2x", "freeze_at": 5, "batch": BATCH,
           "precision": "bf16", "train_images": ENTRY_TRAIN, "val_images": ENTRY_VAL,
           "dataset_s": time.time() - t0, "native_loaded": lib is not None,
           "native_lib": None if lib is None else Path(lib._name).name,
           "host_cpus": os.cpu_count(), "nvidia_smi": smi}
    cfg = entry_config(data, root, scan_steps=ENTRY_SCAN, warmup_shapes=True)
    out["kernel_checks"] = entry_kernel_checks(cfg)

    # the loader alone: the host's own rate with the recipe's threads
    coco = CocoJson(cfg.train_path)
    records = data_clean(coco, coco.get_img_ids(), category_maps(coco)[0], cfg.train_pre_path)
    gen = train_batches(records, cfg)
    next(gen)
    t0 = time.perf_counter()
    sizes = [next(gen)["shape"] for _ in range(LOADER_BATCHES)]
    loader_s = time.perf_counter() - t0
    gen.close()
    out.update(loader_threads=cfg.train_cfg["num_threads"], loader_batches=LOADER_BATCHES,
               loader_img_per_s=BATCH * LOADER_BATCHES / loader_s, loader_sizes=sizes)

    # the recipe's run: every size's graph captured first (warmup_shapes),
    # ENTRY_STEPS steps in units of ENTRY_SCAN, a checkpoint at the
    # midpoint, an eval at the end
    wdir = root / "weights"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    state = run_training(cfg, weights_dir=str(wdir))
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches, captured = read_counts(), read_captured()
    steps, evals = read_metrics(wdir)
    warm = [json.loads(line) for line in open(wdir / "metrics.jsonl")]
    warm = [r for r in warm if "warmup_size" in r]
    n_eval_batches = -(-ENTRY_VAL // ENTRY_EVAL_BATCH)
    n_sizes = len(cfg.randomShape["sizes"])
    # one graph per size, captured by warmup_shapes after an eager warm-up
    # run of a unit (ENTRY_SCAN steps), and one graph of the eval batches;
    # every step and eval batch is a replay (the recipe's frozen stage 5
    # runs no K3)
    n_warm = warmup_iters()
    train_steps = ENTRY_STEPS + n_warm * ENTRY_SCAN * n_sizes
    want = {k: a + b for (k, a), b in zip(
        expect({"dcn_fwd": 3}, train_steps).items(),
        expect({"dcn_fwd": 3, "fused_stem": 1}, n_eval_batches + n_warm).values())}
    want_captured = {k: a + b for (k, a), b in zip(
        expect({"dcn_fwd": 3}, ENTRY_SCAN * n_sizes).items(),
        expect({"dcn_fwd": 3, "fused_stem": 1}, 1).values())}
    if state.step != ENTRY_STEPS or launches != want or captured != want_captured:
        raise AssertionError(f"entry run: {state.step} steps, launches {launches}, captured "
                             f"{captured}; want {want}, {want_captured}")
    if sorted(r["warmup_size"] for r in warm) != sorted(cfg.randomShape["sizes"]):
        raise AssertionError(f"warmup rows {warm}")
    if (len(steps) != ENTRY_STEPS // ENTRY_SCAN
            or not all(np.isfinite(r["total_loss"]) for r in steps)):
        raise AssertionError(f"entry metrics rows {steps}")
    files = sorted(os.listdir(wdir))
    need = {f"step{ENTRY_STEPS // 2:08d}.npz", f"step{ENTRY_STEPS:08d}.npz", "last_state.npz",
            "best_model.npz", "metrics.jsonl"}
    if not need <= set(files):
        raise AssertionError(f"checkpoint files {files}, want {sorted(need)}")
    if len(evals) != 1 or len(evals[0]["stats"]) != 12 or not all(
            np.isfinite(v) and -1.0 <= v <= 1.0 for v in evals[0]["stats"]):
        raise AssertionError(f"eval rows {evals}")
    by_size = {}
    for r in steps:   # every size was captured before the first unit
        by_size.setdefault(r["size"][0], []).append(1e3 * r["step_s"])
    out.update(
        steps=ENTRY_STEPS, scan_steps=ENTRY_SCAN, run_s=run_s, launches=launches,
        captured=captured,
        eval_batches=n_eval_batches,
        warmup_s_by_size={r["warmup_size"]: r["secs"] for r in warm},
        warmup_s_total=sum(r["secs"] for r in warm),
        first_unit_ms_per_step=1e3 * steps[0]["step_s"], first_unit_size=steps[0]["size"][0],
        step_ms_median_by_size={k: statistics.median(v) for k, v in sorted(by_size.items())},
        units_by_size={k: len(v) for k, v in sorted(by_size.items())},
        step_ms_median=statistics.median(1e3 * r["step_s"] for r in steps),
        losses_first=steps[0]["total_loss"], losses_last=steps[-1]["total_loss"],
        files={f: (wdir / f).stat().st_size for f in files if f.endswith((".npz", ".jsonl"))},
        map_stats=evals[0]["stats"], eval_s=evals[0]["eval_s"],
        eval_img_per_s=ENTRY_VAL / evals[0]["eval_s"])
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(entry_eval_groups(cfg, state, root))
    out.update(entry_steady(state, cfg, records))
    del state
    torch.cuda.empty_cache()
    out.update(entry_resume(data, root))
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return launches, captured


def entry_kernel_checks(cfg) -> dict:
    """K1 and K2 against their plain versions on the card at every shape
    the entry gives them, before its run (so outside its counts): K1 on
    each training size's stage-5 grids (stride 2 on size/16, stride 1 on
    size/32) at the training batch, K1 and K2 at the eval batch and size.
    Any miss of the TOL bound raises."""
    import torch
    from ppyolo_tpu_torch.ops.deform_conv import deform_conv2d_plain
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_fwd, pack_dcn_weight
    from ppyolo_tpu_torch.ops.stem import fused_stem, fused_stem_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(300)
    n_train = cfg.train_cfg["batch_size"]
    n_eval, s_eval = cfg.eval_cfg["eval_batch_size"], cfg.eval_cfg["target_size"]
    grids = sorted({(n, s // div, stride)
                    for n, sizes in ((n_train, cfg.randomShape["sizes"]), (n_eval, [s_eval]))
                    for s in sizes for div, stride in ((16, 2), (32, 1))})
    checks = []
    for n, h, stride in grids:
        x, w, om, _ = dcn_inputs(gen, n, 512, h, stride, dev)
        got = dcn_fwd(x, om, pack_dcn_weight(w), None, ksize=(3, 3), stride=stride, padding=1)
        want = deform_conv2d_plain(x, w, om, stride=stride, padding=1)
        checks.append({"kernel": "dcn_fwd", "x": [n, h, h, 512], "stride": stride,
                       **check_close(f"dcn_fwd {n}x{h}x{h}/s{stride}", got, want)})
    x, ws, packed = stem_inputs(gen, n_eval, s_eval, dev)
    got, want = fused_stem(x, *ws, packed=packed), fused_stem_plain(x, *ws)
    checks.append({"kernel": "fused_stem", "x": [n_eval, s_eval, s_eval, 3],
                   **check_close(f"fused_stem {n_eval}x{s_eval}", got, want)})
    torch.cuda.synchronize()
    return {"shapes": len(checks), "tol": TOL,
            "worst_err_over_ref": max(c["max_abs_err"] / c["max_abs_ref"] for c in checks),
            "checks": checks}


def entry_eval_groups(cfg, state, root: Path) -> dict:
    """The eval of the run's final params with ``scan_group`` 1 and
    ENTRY_SCAN_GROUP (``entry.eval.run_eval``): the 12 stats and the merged
    detections equal, K1 3 and K2 1 per eval batch in the trace of the
    grouped run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from ppyolo_tpu_torch.entry.eval import run_eval
    from ppyolo_tpu_torch.entry.train import eval_state_dict

    params = eval_state_dict(state)
    stats, dets = {}, {}
    for g in (1, ENTRY_SCAN_GROUP):
        rdir = root / f"eval_group{g}"
        if g == 1:
            stats[g] = run_eval(cfg, state_dict=params, precision="bf16", result_dir=str(rdir))
        else:
            zero_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                stats[g] = run_eval(cfg, state_dict=params, precision="bf16",
                                    result_dir=str(rdir), scan_group=g)
            check_counts_in_trace(prof, "grouped eval")
        dets[g] = (rdir / "bbox_detections.json").read_text()
    # the trace holds the replayed batches and the eager warm-up run of the
    # group's graph (its capture launches nothing)
    n_batches = -(-ENTRY_VAL // ENTRY_EVAL_BATCH)
    per_batch = kernel_launches(prof, n_batches + ENTRY_SCAN_GROUP * warmup_iters())
    if not np.array_equal(stats[1], stats[ENTRY_SCAN_GROUP]) or dets[1] != dets[ENTRY_SCAN_GROUP]:
        raise AssertionError(f"eval with scan_group {ENTRY_SCAN_GROUP} differs from 1: "
                             f"{stats}")
    if per_batch["dcn_fwd"] != 3 or per_batch["fused_stem"] != 1:
        raise AssertionError(f"grouped eval: launches per batch {per_batch} in the trace")
    return {"eval_scan_group": ENTRY_SCAN_GROUP, "eval_stats_equal_scan_group_1": True,
            "eval_launches_per_batch": per_batch}


def entry_steady(state, cfg, records) -> dict:
    """STEADY_STEPS steps on the state the entry left, the entry's loop
    (``step_loop`` over units of ENTRY_SCAN steps, each a graph replay,
    the pinned prefetcher, one sync at the end) after one warm unit, every
    size's graph captured first: once fed by the live loader (its worker
    threads beside the stepping thread) and once on the same batches made
    beforehand; device time by kernel class over the second
    (``torch.profiler``), K1, K2, K3 per step from its trace.  Both see the
    same sizes: the stream is keyed by the iteration."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ppyolo_tpu_torch.data.loader import (DevicePrefetcher, Prefetcher, stack_units,
                                              train_batches)
    from ppyolo_tpu_torch.tools.warmup_shapes import warmup_units
    from ppyolo_tpu_torch.train.loop import make_unit_step, step_loop
    from ppyolo_tpu_torch.train.train_step import make_train_step

    dev = next(state.model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(3)
    unit_step = make_unit_step(state.model, cfg, state, gen, n_steps=ENTRY_SCAN,
                               compute_dtype=torch.bfloat16)
    start = state.step
    n_host = STEADY_STEPS + ENTRY_SCAN

    def stream():
        return train_batches(records, cfg, start_iter=start, shape_group=ENTRY_SCAN)

    def timed(batches):
        """ms per step over the STEADY_STEPS after the warm unit."""
        nonlocal state
        first, marks = state.step, []

        def mark(st):   # after the warm unit and after the last one
            if st.step in (first + ENTRY_SCAN, first + n_host):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

        state = step_loop(state, unit_step, DevicePrefetcher(stack_units(batches, ENTRY_SCAN),
                                                             dev),
                          gen, max_iters=first + n_host, log_every=0, n_steps=ENTRY_SCAN,
                          after_step=mark)
        return 1e3 * (marks[1] - marks[0]) / STEADY_STEPS

    gen_b = stream()
    host = [next(gen_b) for _ in range(n_host)]
    gen_b.close()
    capture_s = warmup_units(unit_step, cfg, dev, sizes={b["shape"] for b in host},
                             scan_steps=ENTRY_SCAN)
    live = Prefetcher(stream(), max(cfg.train_cfg["max_batch"], ENTRY_SCAN))
    try:
        live_ms = timed(live)
    finally:
        live.close()
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        preloaded_ms = timed(iter(host))
    check_counts_in_trace(prof, "steady steps")
    total, top, by_class = device_time(prof, n_host, 12)
    per_step = kernel_launches(prof, n_host)
    if per_step != {"dcn_fwd": 3, "dcn_bwd": 0, "fused_stem": 0, "conv_s2": 0}:
        raise AssertionError(f"steady steps: launches per step {per_step} in the trace")
    unit = {k: torch.from_numpy(np.stack([b[k] for b in host[:ENTRY_SCAN]])).to(dev)
            for k in ("image", "gt_bbox", "gt_class", "gt_score")}
    graphed = unit_host_ms(lambda: unit_step(state, unit, gen), ENTRY_SCAN)
    eager_fn = make_train_step(state.model, cfg, compute_dtype=torch.bfloat16)
    one = {k: v[0] for k, v in unit.items()}
    eager = unit_host_ms(lambda: eager_fn(state, one, gen), 1)
    return {"steady_steps": STEADY_STEPS,
            "steady_sizes": [b["shape"] for b in host[ENTRY_SCAN:]],
            "steady_capture_s": capture_s,
            "steady_ms_per_step_live_loader": live_ms,
            "steady_ms_per_step_preloaded": preloaded_ms,
            "steady_device_ms_per_step": total,
            "steady_device_idle_share_live_loader": max(0.0, 1.0 - total / live_ms),
            "steady_device_idle_share_preloaded": max(0.0, 1.0 - total / preloaded_ms),
            "launches_per_step": per_step, "steady_by_class": by_class,
            "steady_top": top[:8], "host_ms_per_step_graphed_unit": graphed,
            "host_ms_per_step_eager": eager, "host_size": host[0]["shape"]}


def unit_host_ms(run, n_steps: int) -> dict:
    """The host side of one unit of ``n_steps`` steps, per step: enqueue ms
    (the unit returns before the card finishes) and wait ms, medians of 3."""
    import statistics

    import torch

    run()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
    enqueue, wait = (1e3 * statistics.median(c) / n_steps for c in zip(*times))
    return {"enqueue_ms": enqueue, "wait_ms": wait}


def entry_resume(data: dict, root: Path) -> dict:
    """RESUME_STEPS straight against RESUME_STEPS / 2, ``resume_state``,
    and the rest, DropBlock off, cuDNN deterministic with autotuning off:
    params, momentum buffers and EMA bitwise equal, or, if they are not,
    no farther apart than two straight runs are."""
    import torch
    from ppyolo_tpu_torch.entry.train import run_training

    def cfg_for(**train):
        cfg = entry_config(data, root, **dict(dict(
            max_iters=RESUME_STEPS, save_iter=10 ** 9, eval_iter=10 ** 9, log_iter=0,
            scan_steps=ENTRY_SCAN), **train))
        cfg.head = dict(cfg.head, drop_block=False)
        return cfg

    bench, det = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        straight = state_arrays(run_training(cfg_for(), weights_dir=str(root / "straight")))
        wdir = root / "resumed"
        run_training(cfg_for(max_iters=RESUME_STEPS // 2, save_iter=RESUME_STEPS // 2),
                     weights_dir=str(wdir))
        resumed = state_arrays(run_training(
            cfg_for(resume_state=str(wdir / "last_state.npz")), weights_dir=str(wdir)))
        diff = state_diff(resumed, straight)
        out = {"resume_steps": f"{RESUME_STEPS // 2}+{RESUME_STEPS // 2} vs {RESUME_STEPS}",
               "resume_bitwise": diff["leaves_differ"] == 0, "resume_vs_straight": diff}
        if diff["leaves_differ"]:
            again = state_arrays(run_training(cfg_for(), weights_dir=str(root / "again")))
            spread = state_diff(again, straight)
            out["straight_vs_straight"] = spread
            if not diff["rel_l2"] <= 2.0 * spread["rel_l2"]:
                raise AssertionError(f"resumed run {diff} beyond twice the run-to-run "
                                     f"spread {spread}")
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
    return out


def main() -> int:
    import faulthandler

    faulthandler.enable()   # a crash in native code still shows its Python stack
    try:
        import torch

        name, smi = phase_device()
        sys.path.insert(0, str(REPO))
        torch.backends.cudnn.allow_tf32 = False        # fp32 plain versions in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_build()
        rows = phase_kernels()
        counts = {"probe": phase_probe()}
        det, sd, images, sizes, batch_ms, counts["serving"] = phase_serving(smi)
        phase_profile(det, images, sizes, batch_ms)
        phase_graphs_serving(det, sd, smi)
        del det
        torch.cuda.empty_cache()
        state, cfg, host, step_ms, counts["training"] = phase_training(smi)
        phase_train_profile(state, cfg, host, step_ms)
        del state
        torch.cuda.empty_cache()
        phase_graphs_training(smi)
        torch.cuda.empty_cache()
        phase_train_check()
        torch.cuda.empty_cache()
        counts["entry"] = phase_entry(smi)
    except Exception as e:  # report and fail: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    for k, row in rows.items():   # each path's counts, read just after it ran
        by_path = {path: c[0][k] for path, c in counts.items()}
        row["launches"] = by_path[MAIN_PATH[k]]
        row["launches_by_path"] = by_path
        row["captured_by_path"] = {path: c[1][k] for path, c in counts.items()}
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
