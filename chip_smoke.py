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
               K5 (the int8 conv) at every int8 conv shape of ppyolo_2x@608
               b8 (65 convs, 32 shapes, 28 (k, Cin, Cout) classes, read by
               hooks in one 32-px forward) bit-equal to
               ``quantized_conv2d_plain`` with the dynamic scale and a
               static one that clips, timed beside the plain version,
               cuDNN's bf16 ``F.conv2d`` of the shape (``library_ms``) and
               ``torch._int_mm`` on the 1x1s it takes, in total and by
               class (3x3 s1, 3x3 s2, 1x1 with C % 8 = 0, 1x1 with C = 2
               mod 8), each shape with its ``k5_plan`` and blocks per SM,
               then at shapes no config serves (C past a resident A tile,
               so streamed; an odd Co); K6 (the greedy NMS keep, from the
               candidates' boxes) at b8 with k = 500 and 1500, bit-equal to
               its plain version (the eager suppress matrix and the
               fixpoint), timed beside it and, at k = 500, beside its first
               form with the eager chain that fed it (``tools/kernel_ab``);
               bounds at 1,979 TOP/s int8 (K5) and 67 TFLOP/s fp32 (K6);
               K7 (train-mode BatchNorm with its activation) on the 76
               BatchNorm layers of a b8@608 fine-tuning step, each held
               against autograd of ``_forward_train`` and its activation,
               all forwards and backwards timed in one CUDA graph beside
               the plain chain and the bound (16 bytes an element).
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
               the counters equal to each trace's).  Then the head's
               virtual-concat A/B (``head_decompose``): ``off``, ``inner``
               and ``on``, each mode's replays bit-equal to its eager
               predict, timed as graph replays in HEAD_AB_ROUNDS windows
               of SERVE_MODE_BATCHES batches taken in turn (off inner on,
               on inner off, ...), device ms by class from a 3-batch trace
               of each, and the concats of an eager predict (a
               ``TorchFunctionMode``): no CoordConv [B,C+2,H,W] or SPP
               [B,4C,H,W] concat is written
               under ``inner`` (and 13 a batch under ``off``); the fastest
               mode beside ``auto``'s choice for eval bf16.
6c. export -- the serving artifact (``eval/export.py``) of the serving
               Detector (ppyolo_2x@608 bf16, full width): the kernel form
               (K1 and K2 as ``ppyolo::`` operators) at b8 exported, saved,
               loaded and equal to ``predict_batch`` and the eager forward
               (labels equal; scores and boxes bitwise, or within 1e-6),
               K1 3 and K2 1 launches a call by the counters and in a
               trace, its img/s (each call a CUDA graph replay of the
               program) over EXPORT_WINDOWS windows beside
               ``predict_batch``'s in turn, export, save and load seconds;
               the plain form at EXPORT_PLAIN_BATCH: no kernel launched,
               equal to the eager forward under the same forms.
6d. converter -- the serving weights written as a reference ``.pt`` and as
               a ``.pdparams`` pickle (the Paddle names of
               ``checkpoint/convert.py::paddle_names``), converted on the
               CPU (every leaf bitwise the weights), then served on the card
               through a Detector of their own: detections bit-equal to the
               serving Detector's on the same batch.
6e. int8_serving -- ppyolo_2x@608 b8 (BN calibrated as in serving) through
               ``Detector(precision="int8")``, graph replays: K1 3, K2 1 and K5
               65 launches a batch (counted, and in a trace); img/s in int8,
               bf16, bf16, int8 windows, device ms and idle share of each;
               graphed bit-equal to eager; ``calibrate`` on one batch pins 65
               fp32 act scales and releases the graph, the next batch
               captures anew, bit-equal to eager again, static serving timed;
               the card's int8 head maps within 0.2 (relative L2) of its bf16
               maps (identity BN, 2 x 160 px; twice the CPU test's bound).
6e2. export_int8 -- the calibrated int8 Detector exported in the kernel
               form at b8 (``eval/export.py``): 65 ``ppyolo::quantized_conv2d``,
               3 ``dcn_fwd`` and 1 ``fused_stem`` nodes; K5 65, K1 3, K2 1
               launches a call (counted, and in a trace); bitwise the int8
               ``predict_batch``; each call a CUDA graph replay of the
               program, img/s in windows taken in turn with ``predict_batch``'s;
               export, save and load seconds.
6f. multiclass -- the same int8 model with ``nms_type='multiclass_nms'``:
               K6 once a batch beside K1, K2 and K5, graphed bit-equal to
               eager, img/s and device ms; the NMS of a served batch alone
               (on the decode's outputs): device ms split into K6 and the
               rest, its ms in a CUDA graph, and no op on a [B, k, k]
               tensor.
6g. serving_entries -- ``entry.demo`` at int8 on 16 synthetic jpgs (drawn
               images, fps, device ms) and ``entry.test_dev`` at int8 on the
               same images (the submission json written and parsed), through
               their ``main`` with ``--config 0`` pointed at the synthetic
               set; K1, K2 and K5 launched 3 : 1 : 65.
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
               and to the 4 one-step replays; then the 'prescan' and
               'doublebuf' units are destroyed (``del``, ``gc.collect()``,
               ``empty_cache()``) before the profiled replays of the live
               ones (``train/graphs.py::GraphPool``); ms/step, enqueue ms,
               idle share of eager, one-step and 4-step replays, capture
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
9b. gn_serving -- ppyolo_2x with ``norm_type="gn"`` in the backbone and the
               head (``gn_config``, a copy of the config), b8@608 bf16, random
               weights from a seed, graph replays: K1 3 and K2 0 a batch
               (counted, and in a trace: the stem gate declines a GN stem);
               graphed bitwise the eager forward; the card's bf16 head maps
               no farther from the CPU's fp32 maps than GN_GAP_FACTOR x the
               CPU's bf16 maps (2 x 160 px); img/s over GN_WINDOWS windows,
               device ms by class, idle share, TFLOP/s and MFU.
9c. gn_training -- the GN model fine-tuning (``freeze_at=0``, bf16, EMA,
               DropBlock, b8@608) through ``run_training``, one-step replays:
               K1 3 and K3 3 a step, finite losses, TFLOP/s and MFU from the
               logged records; GN_GRAPH_STEPS graphed steps bitwise as many
               eager ones (cuDNN deterministic); device ms by class; one fp32
               step on the card within 2e-3 of the CPU path's losses.
9d. psroi  -- ``ops/deform_psroi_pool.py`` on the card against the CPU at a
               Deformable R-FCN size ([1, 81*49, 38, 38], 300 ROIs, 7x7 bins,
               class-agnostic offsets): forward within 1e-5, gradients within
               1e-5 relative L2; forward and backward ms.
9e. profile_serving -- ``tools/profile_serving.py`` at b8@608 bf16: the
               stage ablation, the hot kernels and the top convs by time with
               their utilization against the card's peak (``utils/mfu.py``).
               MFU: the profile phase (BN serving), gn_serving, training,
               gn_training and the entry's ``metrics.jsonl`` rows each give
               TFLOP/s and MFU (``utils/mfu.py``: FlopCounterMode plus the
               launched kernels' formulas, counted on each graph's warm-up
               run); any missing, 0, or MFU >= 1 fails.  The kernel phase's
               bounds take their FLOPs from the same formulas.
11. distributed -- data parallelism (``ppyolo_tpu_torch/parallel``) on the
               one card, in two layouts (NCCL refuses two ranks on one
               device).  (a) NCCL at world 1 in this process: DIST_STEPS
               graphed ``sync_bn`` fine-tuning steps (b8@608 bf16,
               ``freeze_at=0``, cuDNN deterministic) bitwise equal to as many
               without a group; the collectives of an eager step (the
               gradient bucket and 2 per sync-BN layer), NCCL's kernels and
               K1/K3 in a replay's trace; host ms per unit with and without
               the group; a remat step (losses within 2e-3 of the plain
               step's, K1 6 a step), host ms per remat unit and both eager
               peaks; ``predict_sharded`` equal to ``predict_batch``; the
               training entry under the group (``--scan_steps 4``,
               ``warmup_shapes``, ``ckpt_backend='orbax'`` -> DCP) resuming
               bitwise.  Counters zeroed as the group starts and read as it
               ends (the ``distributed`` path: K1, K3 and K2 each launched).
               (b) gloo at world 2: two ranks spawned as
               ``chip_smoke.py --gloo-rank``, eager (a graph cannot hold
               gloo's host-staged collectives): GLOO_STEPS bf16 steps each,
               DropBlock on, params, BN statistics, momentum and EMA bitwise
               equal on both ranks after each; an fp32 step's losses within
               2e-3 of one process's step on both batches (b16); then
               ``entry.eval`` on both ranks: every image's shard once, the
               merged detections and 12 stats equal to a one-process eval.

12. cards  -- only where the host has more than one card (the one-card run
               skips it): one NCCL rank a card, spawned as ``chip_smoke.py
               --card-rank``: CARDS_STEPS graphed ``sync_bn`` steps a rank,
               bitwise in lockstep, NCCL kernels in a replay's trace, host ms
               a unit against rank 0's card alone; then the training entry
               under the group with DCP and a periodic eval on rank 0 while
               the others wait in their next collective.

Every phase's line carries ``phase_s``, the seconds since the phase began.
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
sys.path.insert(0, str(REPO))
from ppyolo_tpu_torch.utils import mfu  # noqa: E402  (the kernels' FLOP formulas)
from ppyolo_tpu_torch.utils.profiling import cuda_ms, device_time, device_trace  # noqa: E402
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
TOL = 0.02                   # max-abs error / max-abs of the plain output
DISTINCT_SETS = 8            # input sets rotated through for the L2-cold kernel times
BATCH, SIZE = 8, 608
WARMUP_BATCHES = 2
GROUP = 4                         # batches a predict_pipelined replay serves
SERVE_MODE_BATCHES = 40           # batches timed per serving mode
HEAD_MODES = ("off", "inner", "on")   # the head's virtual-concat modes of the A/B
HEAD_AB_ROUNDS = 3                # windows per head mode, taken in turn
EXPORT_WINDOWS, EXPORT_WINDOW_CALLS = 5, 10   # the artifact timed against predict_batch
EXPORT_PLAIN_BATCH = 2            # the plain-form artifact's batch
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
DIST_STEPS = 4                   # graphed steps under NCCL world 1, and without a group
DIST_TIMED_UNITS = 4             # replays timed with and without the group
DIST_ENTRY_STEPS = 8             # the entry under the group: 2 units of ENTRY_SCAN
GLOO_STEPS = 2                   # lockstep steps of each of the 2 gloo ranks
GLOO_TIMEOUT_S = 600             # the gloo ranks' wait, after which both are killed
CARDS_STEPS = 4                  # graphed steps a rank with one rank on every card
CARDS_TIMEOUT_S = 900            # the card ranks' wait, after which all are killed
INT8_CONVS, INT8_CLASSES = 65, 28  # int8 convs of ppyolo_2x, and their (k, Cin, Cout) classes
# tests/test_torch_port_int8.py: the port's int8 head maps lie 4.2e-2 to
# 7.2e-2 (relative L2 by level) from its bf16 maps on the CPU, gated there at
# INT8_BF16_GAP; the card's int8-vs-bf16 maps are held at twice that bound
# (another model's random weights, the card's rounding order)
INT8_BF16_GAP, INT8_GAP_FACTOR = 0.1, 2.0
INT8_WINDOW_BATCHES = 20         # timed batches per serving window (int8, bf16, bf16, int8)
MC_BATCHES = 6                   # multiclass-NMS batches after one warm-up
# K5 at shapes no config serves, b8: C past a resident A tile (the
# streamed layout: a 1x1 with C 4096 and a 3x3 with C 2048 at 19x19, a 3x3
# s2 with C 1024 at 38x38) and an odd Co; (C, H, W, Co, k, stride)
K5_EXTRA_SHAPES = ((4096, 19, 19, 512, 1, 1), (2048, 19, 19, 512, 3, 1),
                   (1024, 38, 38, 256, 3, 2), (258, 38, 38, 255, 3, 1))
NMS_B, NMS_K = BATCH, 500        # K6's check: b8, k = nms_top_k
NMS_K_WIDE = 1500                # and past its first form's cap of 1024
DEMO_IMAGES = 16                 # synthetic jpgs through entry.demo and entry.test_dev
GN_WINDOWS, GN_WINDOW_BATCHES = 5, 20   # timed GN serving: 100 batches
GN_TRAIN_STEPS = 6               # GN fine-tuning steps timed after TRAIN_WARMUP
GN_GRAPH_STEPS = 2               # GN graphed vs eager steps, bitwise
GN_GAP_FACTOR = 1.1              # the card's bf16 GN maps' gap to fp32 over the CPU bf16 path's
# deform_psroi_pool at a Deformable R-FCN size (81 classes, 7x7 bins, stride 16)
PSROI = dict(spatial_scale=1.0 / 16, output_dim=81, group_size=7, pooled_size=7, part_size=7,
             sample_per_part=4, trans_std=0.1)
PSROI_MAP, PSROI_ROIS = 38, 300
# the path whose run gives each kernel's ``launches``
EXPORT_DIR = REPO / "build" / "chip_smoke_export"   # artifacts and converted weights
MAIN_PATH = {"dcn_fwd": "serving", "fused_stem": "serving", "dcn_bwd": "training",
             "conv_s2": "probe", "conv_int8": "int8_serving", "nms_keep": "multiclass",
             "bn_train_fwd": "training"}


SMI = ""   # nvidia-smi's name and power limit, set by phase_device
PHASE_T0 = time.perf_counter()   # set by main as each phase begins


def begin() -> None:
    """Mark the start of a phase (its lines' ``phase_s``)."""
    global PHASE_T0
    PHASE_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = dict(obj, phase_s=round(time.perf_counter() - PHASE_T0, 3))
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def wrappers() -> dict:
    """Each kernel's launch wrapper: ``launches`` counts its kernel's
    launches (a CUDA graph adds the calls it recorded at each replay),
    ``captured`` the calls recorded into graphs."""
    from ppyolo_tpu_torch.ops.bn_train import bn_train_bwd, bn_train_fwd
    from ppyolo_tpu_torch.ops.conv_int8 import quantized_conv2d
    from ppyolo_tpu_torch.ops.deform_conv_cuda import dcn_bwd, dcn_fwd
    from ppyolo_tpu_torch.ops.matrix_nms import nms_keep
    from ppyolo_tpu_torch.ops.stem import fused_stem
    from ppyolo_tpu_torch.ops.strided_conv import conv_s2

    return {"dcn_fwd": dcn_fwd, "dcn_bwd": dcn_bwd, "fused_stem": fused_stem,
            "conv_s2": conv_s2, "conv_int8": quantized_conv2d, "nms_keep": nms_keep,
            "bn_train_fwd": bn_train_fwd, "bn_train_bwd": bn_train_bwd}


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


def bn_calls(model, remat: bool = False) -> dict:
    """K7's calls in one training step of ``model``: a forward for every
    BatchNorm (the backbone's twice under remat, which recomputes it) and a
    backward for each layer with a trainable parameter (the frozen stages
    come first, so a gradient reaches no frozen layer)."""
    from ppyolo_tpu_torch.ops.conv import ConvNormAct

    layers = [(name, m) for name, m in model.named_modules()
              if isinstance(m, ConvNormAct) and m.bn is not None]
    again = sum(name.startswith("backbone.") for name, _ in layers) if remat else 0
    return {"bn_train_fwd": len(layers) + again,
            "bn_train_bwd": sum(any(p.requires_grad for p in m.parameters()) for _, m in layers)}


def cfg_bn_calls(cfg) -> dict:
    """``bn_calls`` of the model ``cfg`` builds (on the CPU, untouched)."""
    from ppyolo_tpu_torch.models import PPYOLO

    return bn_calls(PPYOLO.from_config(cfg))


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
    global SMI
    smi = SMI = nvidia_smi()
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
    exported by its library; ``args`` picks one of K3's two kernels, or K5's
    warpgroup layout, whether it streams C and its shared memory) beside
    ptxas's registers and shared memory."""
    from ppyolo_tpu_torch.ops import _build

    fn = {"conv_s2": "conv_s2_bf16_blocks_per_sm", "fused_stem": "fused_stem_blocks_per_sm",
          "dcn_fwd": "dcn_fwd_blocks_per_sm", "dcn_bwd": "dcn_bwd_blocks_per_sm",
          "conv_int8": "conv_int8_blocks_per_sm"}[name]
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
        flops = mfu.dcn_fwd_flops(BATCH, oh, oh, 9, 512, 512)
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
    flops = mfu.fused_stem_flops(BATCH, SIZE, SIZE)
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
    rows["conv_int8"] = kernel_k5(gen, dev)
    rows["nms_keep"] = kernel_k6(gen, dev)
    rows["bn_train_fwd"] = kernel_k7(dev)
    return rows


def bn_train_layers(cfg) -> list:
    """(C, H, W, act) of every BatchNorm of ``cfg``'s model at SIZE, in
    forward order, with the activation K7 applies there (its layer's, or
    None where that is mish): read by forward pre-hooks on one eval forward
    of one image on the card."""
    import torch
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.bn_train import ACTS
    from ppyolo_tpu_torch.ops.conv import ConvNormAct

    model = PPYOLO.from_config(cfg).to("cuda").eval()
    acts = {m.bn: m.act for m in model.modules() if isinstance(m, ConvNormAct) and m.bn}
    layers = []

    def hook(bn, inp):
        _, c, h, w = inp[0].shape
        layers.append((c, h, w, acts[bn] if acts[bn] in ACTS else None))

    hooks = [bn.register_forward_pre_hook(hook) for bn in acts]
    with torch.no_grad():
        model.outputs(torch.zeros(1, 3, SIZE, SIZE, device="cuda"))
    for h in hooks:
        h.remove()
    return layers


def kernel_k7(dev) -> dict:
    """K7 on one fine-tuning step's BatchNorm layers of ppyolo_2x at
    b8@608 (bf16 activations and parameters, fp32 running statistics): each
    layer's forward and backward held against autograd of
    ``_forward_train`` then its activation (``check_close``); all layers'
    forwards then backwards (in reverse) timed in one CUDA graph, beside
    the plain chain (eager autograd, every layer) and the bound: 16 bytes an
    element (x read twice, y written; dy and x read twice, dx written), and
    10 where each input is read once."""
    import torch
    from ppyolo_tpu_torch.ops.bn_train import bn_train, bn_train_bwd, bn_train_fwd
    from ppyolo_tpu_torch.ops.conv import apply_act
    from ppyolo_tpu_torch.ops.module import BN_EPS, BN_MOMENTUM, BatchNorm
    from ppyolo_tpu_torch.tools.kernel_ab import graph_ms

    layers = bn_train_layers(train_config())
    gen = torch.Generator(device=dev).manual_seed(7)
    cl, bf = torch.channels_last, torch.bfloat16
    sets = []
    for c, h, w, act in layers:
        shape = (BATCH, c, h, w)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.2).to(bf)
        sets.append(dict(
            x=x.contiguous(memory_format=cl), act=act,
            dy=torch.randn(shape, generator=gen, device=dev).to(bf).contiguous(memory_format=cl),
            w=(torch.randn(c, generator=gen, device=dev) * 0.2 + 1).to(bf),
            b=(torch.randn(c, generator=gen, device=dev) * 0.2).to(bf),
            rm=torch.zeros(c, device=dev), rv=torch.ones(c, device=dev)))
    err = 0.0
    for s in sets:   # each layer against the plain chain
        xg, wg, bg = (s[k].clone().requires_grad_(True) for k in ("x", "w", "b"))
        y = bn_train(xg, wg, bg, s["rm"].clone(), s["rv"].clone(), act=s["act"], update=True,
                     sync=False, eps=BN_EPS, momentum=BN_MOMENTUM)
        got = (y,) + torch.autograd.grad(y, (xg, wg, bg), s["dy"])
        bn = BatchNorm(xg.shape[1]).to(dev).train()
        bn.weight, bn.bias = (torch.nn.Parameter(s[k].clone()) for k in ("w", "b"))
        xp = s["x"].clone().requires_grad_(True)
        yp = apply_act(bn._forward_train(xp), s["act"])
        want = (yp,) + torch.autograd.grad(yp, (xp, bn.weight, bn.bias), s["dy"])
        for name, g, wt in zip(("y", "dx", "dweight", "dbias"), got, want):
            err = max(err, check_close(f"bn_train {tuple(xg.shape)} {s['act']} {name}", g,
                                       wt)["max_abs_err"] / max(float(wt.float().abs().max()),
                                                                1e-30))
    torch.cuda.synchronize()

    def step():
        kw = dict(eps=BN_EPS)
        outs = [bn_train_fwd(s["x"], s["w"], s["b"], s["rm"], s["rv"], act=s["act"],
                             update=True, momentum=BN_MOMENTUM, **kw) for s in sets]
        for s, (_, sums) in zip(reversed(sets), reversed(outs)):
            bn_train_bwd(s["dy"], s["x"], sums, s["w"], s["b"], act=s["act"], **kw)

    def plain():
        for s in sets:
            bn = BatchNorm(s["x"].shape[1]).to(dev).train()
            bn.weight, bn.bias = (torch.nn.Parameter(s[k].clone()) for k in ("w", "b"))
            xp = s["x"].clone().requires_grad_(True)
            yp = apply_act(bn._forward_train(xp), s["act"])
            torch.autograd.grad(yp, (xp, bn.weight, bn.bias), s["dy"])

    ms = graph_ms(step, 3)
    pms = cuda_ms(plain, 3, warmup=1)
    elems = sum(s["x"].numel() for s in sets)
    b16, _ = bound_ms(0.0, 16 * elems)
    b10, _ = bound_ms(0.0, 10 * elems)
    by_act = {str(a): sum(1 for s in sets if s["act"] == a) for a in (None, "relu", "leaky")}
    row = dict(name="bn_train", route="cuda", source="ppyolo_tpu_torch/csrc/bn_train.cu",
               replaces="none: JAX leaves batch_norm to XLA (ppyolo_tpu/ops/conv.py::batch_norm)",
               per=f"training step of {BATCH} ({len(sets)} layers, forward and backward)",
               layers=len(sets), acts=by_act, elements_per_step=elems, ms=ms, plain_ms=pms,
               bound_ms=b16, bound_by="bytes", bound_ms_each_input_once=b10,
               gb_per_s=16 * elems / ms / 1e6, x_bound=ms / b16, max_rel_err=err,
               library_ms=None)
    emit({"phase": "kernel_check", "kernel": "bn_train", **row})
    del sets
    torch.cuda.empty_cache()
    return row


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
        flops = mfu.conv_s2_flops(BATCH, s, c, co)
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


def int8_conv_shapes(cfg):
    """The int8 convs of ``cfg``'s model served at SIZE, batch BATCH
    (``eval.optimize.int8_conv_shapes``: hooks in one 32-px forward on the
    CPU).  Returns ([(C, H, W, Co, k, stride, convs of that shape)], the
    number of int8 convs)."""
    from ppyolo_tpu_torch.eval.optimize import int8_conv_shapes as shapes_of
    from ppyolo_tpu_torch.models import PPYOLO

    shapes = shapes_of(PPYOLO.from_config(cfg).eval(), SIZE, BATCH)
    return shapes, sum(s[-1] for s in shapes)


def k5_shape(gen, dev, c, h, w, co, k, stride) -> dict:
    """K5 at one conv shape, b8: bit-equal to ``quantized_conv2d_plain``
    with the dynamic scale and with a static one that clips; timed in CUDA
    graphs of 20 calls (static, dynamic), eagerly (``wrapper_ms``), beside
    the plain version, cuDNN's bf16 ``F.conv2d`` of the shape
    (``library_ms``) and, on a 1x1 stride-1 conv with C and Co % 8 == 0,
    ``torch._int_mm`` on the quantized activation; with its plan, whose
    blocks per SM must be the occupancy API's."""
    import torch
    import torch.nn.functional as F
    from ppyolo_tpu_torch.ops.conv_int8 import (dynamic_act_scale, k5_plan, pack_int8_weight,
                                                quantize_act, quantized_conv2d,
                                                quantized_conv2d_plain, sm_count)
    from ppyolo_tpu_torch.tools.kernel_ab import graph_ms

    x = (torch.randn(BATCH, c, h, w, generator=gen) * 1.5).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (co, c, k, k), generator=gen, dtype=torch.int8).to(dev)
    ws = (torch.rand(co, generator=gen) * 1e-3 + 1e-4).to(dev)
    packed = pack_int8_weight(wq)   # once, outside every timed window
    pad = (k - 1) // 2
    static = dynamic_act_scale(x) * 0.6   # clips the largest activations
    kw = dict(stride=stride, padding=pad)
    with torch.no_grad():
        for act in (None, static):
            got = quantized_conv2d(x, wq, ws, act_scale=act, packed=packed, **kw)
            want = quantized_conv2d_plain(x, wq, ws, act_scale=act, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K5 {(c, h, w, co, k, stride)} act_scale {act is not None}: not "
                    f"bit-equal, max abs {float((got.float() - want.float()).abs().max())}")
        wb = (wq.float() * ws.view(-1, 1, 1, 1)).to(torch.bfloat16)
        run_s = lambda: quantized_conv2d(x, wq, ws, act_scale=static, packed=packed, **kw)
        ms, wms = graph_ms(run_s, 20), cuda_ms(run_s, 20)
        msd = graph_ms(lambda: quantized_conv2d(x, wq, ws, packed=packed, **kw), 20)
        pms = cuda_ms(lambda: quantized_conv2d_plain(x, wq, ws, act_scale=static, **kw), 3)
        lms = graph_ms(lambda: F.conv2d(x, wb, **kw), 20)
        imm = None
        if k == 1 and stride == 1 and c % 8 == 0 and co % 8 == 0:
            a = quantize_act(x, static).permute(0, 2, 3, 1).reshape(-1, c)
            b = wq.view(co, c).t()
            imm = graph_ms(lambda: torch._int_mm(a, b), 20)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    ops = mfu.conv_int8_flops(BATCH, oh, ow, co, c, k)
    nbytes = x.numel() * 2 + wq.numel() + co * 4 + BATCH * oh * ow * co * 2
    b, by = bound_ms(ops, nbytes, PEAK_INT8_OPS)
    plan = k5_plan(BATCH, h, w, c, co, k, stride, sm_count(dev))
    bps = occupancy("conv_int8", plan.wg_m, plan.m_tiles, int(plan.streamed),
                    plan.smem_bytes)["blocks_per_sm"]
    if bps != plan.blocks_per_sm:
        raise AssertionError(f"K5 {(c, h, w, co, k, stride)}: the plan counts "
                             f"{plan.blocks_per_sm} blocks an SM, the occupancy API {bps}")
    return {"x": [BATCH, h, w, c], "co": co, "k": k, "stride": stride,
            "ms": ms, "ms_dynamic": msd, "wrapper_ms": wms, "plain_ms": pms, "library_ms": lms,
            "int_mm_ms": imm, "bound_ms": b, "bound_by": by, "gop": ops / 1e9,
            "mbytes": nbytes / 1e6, "tops": ops / ms / 1e9, "x_bound": ms / b,
            "x_library": ms / lms, "max_abs_err": 0.0,
            "t_ops_ms": ops / PEAK_INT8_OPS * 1e3, "t_bytes_ms": nbytes / PEAK_BYTES * 1e3,
            "plan": {"wg_m": plan.wg_m, "m_tiles": plan.m_tiles, "grid": list(plan.grid),
                     "tiles_per_block": plan.tiles_per_block, "c_chunk": plan.c_chunk,
                     "streamed": plan.streamed, "smem_bytes": plan.smem_bytes,
                     "quant_per_element": plan.quant_per_element, "blocks_per_sm": bps}}


def kernel_k5(gen, dev) -> dict:
    """K5 at every int8 conv shape of ppyolo_2x@608 b8 (stride 1 and 2,
    the CoordConv C = 2 mod 8 tails), each through ``k5_shape`` (bit-equal
    to the plain version, timed in CUDA graphs beside it, cuDNN bf16 and
    ``torch._int_mm``).  Per batch: each shape's time times the convs of
    that shape (65 launches), in total and by class (``int8_conv_class``).
    Then K5_EXTRA_SHAPES, which no config serves: C past a resident A tile
    (the streamed layout) and an odd Co, each beside cuDNN bf16."""
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.eval.optimize import int8_conv_class
    from ppyolo_tpu_torch.ops import _build
    from ppyolo_tpu_torch.ops.conv_int8 import K5_MAX_C

    shapes, n_convs = int8_conv_shapes(PPYOLO_2x_Config())
    classes = {(k, c, co) for c, _, _, co, k, _, _ in shapes}
    if n_convs != INT8_CONVS or len(classes) != INT8_CLASSES:
        raise AssertionError(f"{n_convs} int8 convs in {len(classes)} (k, Cin, Cout) classes: "
                             f"want {INT8_CONVS} in {INT8_CLASSES}")
    rows = []
    k5 = {"ms": 0.0, "ms_dynamic": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
          "bound_ms": 0.0, "max_abs_err": 0.0, "int_mm_ms": 0.0, "int_mm_k5_ms": 0.0,
          "int_mm_convs": 0}
    by_class = {}
    t_ops = t_bytes = ops_batch = 0.0
    for c, h, w, co, k, stride, count in shapes:
        row = k5_shape(gen, dev, c, h, w, co, k, stride)
        if row["plan"]["streamed"]:
            raise AssertionError(f"K5 {(c, h, w, co, k, stride)}: a served conv streams C")
        row["convs"] = count
        rows.append(row)
        emit({"phase": "kernel_check", "kernel": "conv_int8", **row, "nvidia_smi": SMI})
        t_ops += count * row["t_ops_ms"]
        t_bytes += count * row["t_bytes_ms"]
        ops_batch += count * row["gop"] * 1e9
        for key in ("ms", "ms_dynamic", "wrapper_ms", "plain_ms", "library_ms", "bound_ms"):
            k5[key] += count * row[key]
        if row["int_mm_ms"] is not None:
            k5["int_mm_ms"] += count * row["int_mm_ms"]
            k5["int_mm_k5_ms"] += count * row["ms"]
            k5["int_mm_convs"] += count
        cls = by_class.setdefault(int8_conv_class(k, c, stride),
                                  {"convs": 0, "ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                                   "int_mm_ms": None, "gop": 0.0})
        cls["convs"] += count
        for key in ("ms", "library_ms", "bound_ms", "gop"):
            cls[key] += count * row[key]
        if row["int_mm_ms"] is not None:
            cls["int_mm_ms"] = (cls["int_mm_ms"] or 0.0) + count * row["int_mm_ms"]
    for cls in by_class.values():
        cls.update(tops=cls["gop"] / cls["ms"], x_bound=cls["ms"] / cls["bound_ms"],
                   x_library=cls["ms"] / cls["library_ms"])
    extra = []
    for c, h, w, co, k, stride in K5_EXTRA_SHAPES:
        extra.append(k5_shape(gen, dev, c, h, w, co, k, stride))
        emit({"phase": "kernel_check", "kernel": "conv_int8", "served": False, **extra[-1],
              "nvidia_smi": SMI})
    if [r["plan"]["streamed"] for r in extra] != [c > K5_MAX_C[k, s]
                                                  for c, _, _, _, k, s in K5_EXTRA_SHAPES]:
        raise AssertionError("K5: the extra shapes past K5_MAX_C must stream, the others not")
    return dict(
        name="conv_int8", route="cuda", source="ppyolo_tpu_torch/csrc/conv_int8.cu",
        replaces="ppyolo_tpu/ops/conv.py:88",
        note="no Pallas kernel: the JAX package computes quantized_conv2d's conv in XLA",
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        per=f"batch of 8 ({INT8_CONVS} launches over {len(shapes)} shapes in {INT8_CLASSES} "
            f"(k, Cin, Cout) classes; static scale; library: cuDNN bf16 F.conv2d)",
        tops=ops_batch / k5["ms"] / 1e9, x_bound=k5["ms"] / k5["bound_ms"],
        x_library=k5["ms"] / k5["library_ms"], by_class=by_class,
        occupancy={"ptxas": ptxas_lines(_build.PTXAS_REPORT.get("conv_int8", ""))},
        shapes=rows, extra_shapes=extra, **k5)


def iou_pairs_needed(valid, labels, sup, keep) -> int:
    """The IoUs the greedy walk needs on these candidates: for each valid i,
    the kept earlier candidates of its label up to the first that
    suppresses it (``sup`` [b, j, i] from ``suppress_matrix``)."""
    import torch

    k = valid.shape[1]
    order = torch.arange(k, device=valid.device)
    cand = (keep[:, :, None] & valid[:, None, :] & (order[:, None] < order[None, :])
            & (labels[:, :, None] == labels[:, None, :]))
    hit = cand & sup
    first = torch.where(hit.any(1), hit.int().argmax(1), k)          # [b, i]
    return int((cand & (order[None, :, None] <= first[:, None, :])).sum())


def kernel_k6(gen, dev) -> dict:
    """K6 at the multiclass path's b8 with k = 500 (ppyolo_2x's nms_top_k)
    and k = 1500 (past its first form's cap) on clustered candidates,
    bit-equal to its plain version (the eager suppress matrix and the
    fixpoint); timed in a CUDA graph of 20 calls beside the plain version
    and, at k = 500, the first form with the eager chain that fed it
    (``tools/kernel_ab``: earlier, current, current, earlier, in this run).
    The bound counts the candidates' bytes and the IoUs the walk needs on
    these candidates (12 fp32 flops each); the walk's k / 32 rounds, each
    ending at a barrier, are its dependent chain."""
    import torch
    from ppyolo_tpu_torch.ops.matrix_nms import nms_keep, nms_keep_boxes_plain, suppress_matrix
    from ppyolo_tpu_torch.tools.kernel_ab import (EARLIER_DIR, NMS_THR, ab, build_earlier,
                                                  earlier_nms_keep, graph_ms, nms_candidates)

    earlier = build_earlier(EARLIER_DIR, ["nms_keep"])["nms_keep"]
    shapes = []
    for k in (NMS_K, NMS_K_WIDE):
        valid, boxes, labels = nms_candidates(gen, NMS_B, k, dev)
        run_k = lambda: nms_keep(valid, boxes, labels, NMS_THR)
        run_p = lambda: nms_keep_boxes_plain(valid, boxes, labels, NMS_THR)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K6 k = {k}: {int((got != want).sum())} keep flags differ")
        ms, pms = graph_ms(run_k, 20), cuda_ms(run_p, 3)
        old = None
        if k <= 1024:
            if not torch.equal(earlier_nms_keep(earlier, valid, boxes, labels), want):
                raise AssertionError(f"K6's first form k = {k}: keep flags differ")
            old = ab(f"nms_keep b{NMS_B} k{k}", lambda: earlier_nms_keep(
                earlier, valid, boxes, labels), run_k, graph_ms)
        sup = suppress_matrix(boxes, labels, NMS_THR)
        pairs = iou_pairs_needed(valid, labels, sup, want)
        nbytes = valid.numel() * 2 + boxes.numel() * 4 + labels.numel() * 4
        b, by = bound_ms(mfu.nms_keep_ops(pairs), nbytes, PEAK_FP32_FLOPS)
        shapes.append({"b": NMS_B, "k": k, "ms": ms, "plain_ms": pms, "bound_ms": b,
                       "bound_by": by, "iou_pairs": pairs, "rounds": -(-k // 32),
                       "kept": int(got.sum()), "valid": int(valid.sum()), "x_bound": ms / b,
                       "first_form_ab": old, "max_abs_err": 0.0})
        emit({"phase": "kernel_check", "kernel": "nms_keep", **shapes[-1], "nvidia_smi": SMI})
    main = shapes[0]
    old = main["first_form_ab"]
    return dict(name="nms_keep", route="cuda", source="ppyolo_tpu_torch/csrc/nms_keep.cu",
                replaces="ppyolo_tpu/ops/matrix_nms.py:146",
                note="no Pallas kernel: the JAX package runs the fixpoint as an XLA while_loop; "
                     "the walk's rounds (k / 32, a barrier each) are its dependent chain",
                library_ms=None, per=f"batch of 8, k = {NMS_K} (one launch)",
                ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], max_abs_err=0.0, rounds=main["rounds"],
                first_form_ms=sum(old["earlier_ms"]) / 2, first_form_ab=old, shapes=shapes)


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
        flops = mfu.dcn_bwd_ops(BATCH, oh, oh, 9, c)   # fp32 on the CUDA cores
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
    # (every head mode: ``head_decompose``)
    from ppyolo_tpu_torch.models.head import head_decompose

    x = np.ascontiguousarray(images[0][:2, 200:360, 200:360])
    maps = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, dev)
        d = Detector(m, {k: v.detach().cpu() for k, v in m.state_dict().items()}, cfg,
                     precision="bf16", device=dev)
        for mode in ("auto",) + HEAD_MODES:
            with torch.no_grad(), head_decompose(mode):
                maps[dev, mode] = [o.float().cpu() for o in d.model.outputs(
                    d.normalize(torch.from_numpy(x).to(dev)))]
    rels = {mode: [float((a - b).norm() / b.norm())
                   for a, b in zip(maps["cuda", mode], maps["cpu", mode])]
            for mode in ("auto",) + HEAD_MODES}
    rel = rels["auto"]
    if not all(r <= 2e-2 for v in rels.values() for r in v):
        raise AssertionError(f"card vs CPU head maps, relative L2 {rels} > 2e-2")

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
              "card_vs_cpu_rel_l2": rel, "card_vs_cpu_rel_l2_by_head_mode": rels,
              "nvidia_smi": smi,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return det, sd, images[0], sizes, result["batch_ms_median"], (launches, captured)


def kernel_launches(prof, units: int) -> dict:
    """Launches of each port kernel per unit, counted from the profiler's
    kernel names (inside CUDA graph replays too)."""
    names = {"dcn_fwd": ("dcn_fwd_kernel",), "dcn_bwd": ("dcn_bwd_kernel",),
             "fused_stem": ("fused_stem_kernel",), "conv_s2": ("conv_s2_",),
             "conv_int8": ("conv_int8_kernel",), "nms_keep": ("nms_keep_kernel",),
             "bn_train_fwd": ("bn_train_fwd_stats",), "bn_train_bwd": ("bn_train_bwd_stats",)}
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

    det.predict_batch(images, sizes)
    torch.cuda.synchronize()
    zero_counts()
    with device_trace() as prof:
        for _ in range(3):
            det.predict_batch(images, sizes)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, "graphed serving")
    total, top, by_class = device_time(prof, 3)
    per_batch = kernel_launches(prof, 3)
    if per_batch != expect({"dcn_fwd": 3, "fused_stem": 1}, 1):
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
          "mfu": serving_mfu(det, batch_ms, total, "bf16 serving"),
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

    big = np.concatenate(batches[:GROUP])
    big_sizes = np.concatenate([sizes] * GROUP)
    from ppyolo_tpu_torch.models.head import decompose_mode

    mode = decompose_mode(False, det.compute_dtype)    # the Detector's graph keys
    graphs = {g: det._graphs[g, mode, "auto", "auto"] for g in (1, GROUP)}

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
        with device_trace() as prof:
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
        if r["launches_per_batch"] != expect({"dcn_fwd": 3, "fused_stem": 1}, 1):
            raise AssertionError(f"{mode}: launches per batch {r['launches_per_batch']}")
    head = head_mode_ab(det, batches, sizes)
    out = {"phase": "graphs_serving", "model": "ppyolo_2x", "size": SIZE, "batch": BATCH,
           "precision": "bf16", "group": GROUP, "bitwise_graphed_vs_eager": True,
           "bitwise_after_set_params": True, "bitwise_pipelined_vs_batches": True,
           "kept_detections": int((first[..., 0] >= 0).sum()),
           "capture_s": {str(k): sum(gr.captures.values()) for k, gr in det._graphs.items()},
           "modes": modes, "head_modes": head, "nvidia_smi": smi,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def artifact_ops(program) -> dict:
    """The ``ppyolo::`` operator nodes of an exported program, by name."""
    ops = {}
    for n in program.graph.nodes:
        t = str(n.target)
        if t.startswith("ppyolo."):
            ops[t.split(".")[1]] = ops.get(t.split(".")[1], 0) + 1
    return ops


def compare_dets(got, want, where: str) -> dict:
    """Labels equal; scores and boxes bitwise, else within 1e-6."""
    import numpy as np

    if not np.array_equal(got[..., 0], want[..., 0]):
        raise AssertionError(f"{where}: labels differ")
    err = float(np.abs(got - want).max())
    if err > 1e-6:
        raise AssertionError(f"{where}: scores/boxes differ by {err} > 1e-6")
    return {"bitwise": bool(np.array_equal(got, want)), "max_abs_diff": err,
            "kept": int((want[..., 0] >= 0).sum())}


def phase_export(det, smi: str):
    """The serving artifact of the serving Detector (ppyolo_2x@608 bf16):
    the kernel form at b8 (K1 and K2 as ``ppyolo::`` operators) exported,
    saved, loaded, equal to ``predict_batch`` and to the eager forward,
    K1 3 and K2 1 launches a call (counters and trace), img/s in windows
    taken in turn with ``predict_batch``'s; the plain form at
    EXPORT_PLAIN_BATCH launching no kernel, equal to the eager forward
    under the same forms.  Returns the kernel form's counts (the
    ``export`` path)."""
    import numpy as np
    import torch
    from ppyolo_tpu_torch.eval.export import (export_detector, load_program, save_serving,
                                              serving_fn)
    from ppyolo_tpu_torch.ops.deform_conv import dcn_form
    from ppyolo_tpu_torch.ops.stem import stem_form

    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(31)
    images = rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    sizes = np.tile(np.array([[480, 640], [608, 608]], np.float32), (BATCH // 2, 1))
    out = {"phase": "export", "model": "ppyolo_2x", "size": SIZE, "precision": "bf16"}
    for form, batch in (("kernel", BATCH), ("plain", EXPORT_PLAIN_BATCH)):
        t0 = time.perf_counter()
        data = export_detector(det, batch=batch, dcn=form, stem=form)
        t1 = time.perf_counter()
        path = EXPORT_DIR / f"ppyolo_2x_{SIZE}_b{batch}_{form}.pt2"
        save_serving(str(path), data)
        t2 = time.perf_counter()
        program = load_program(path.read_bytes())
        serve = serving_fn(program)
        t3 = time.perf_counter()
        ims, szs = images[:batch], sizes[:batch]
        serve(ims, szs)                              # first call
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        r = {"batch": batch, "bytes": len(data), "export_s": t1 - t0, "save_s": t2 - t1,
             "load_s": t3 - t2, "first_call_s": t4 - t3, "ops": artifact_ops(program)}
        zero_counts()
        got = serve(ims, szs)
        r["launches_per_call"] = read_counts()
        if form == "kernel":
            per_call = {"dcn_fwd": 3, "fused_stem": 1}
            if r["ops"] != per_call or r["launches_per_call"] != expect(per_call, 1):
                raise AssertionError(f"kernel-form artifact: ops {r['ops']}, launches "
                                     f"{r['launches_per_call']}")
            r["vs_predict_batch"] = compare_dets(got, det.predict_batch(ims, szs),
                                                 "artifact vs predict_batch")
            r["vs_eager"] = compare_dets(got, eager_predict(det, ims, szs)[0].cpu().numpy(),
                                         "artifact vs the eager forward")
            zero_counts()
            with device_trace() as prof:
                serve(ims, szs)
                torch.cuda.synchronize()
            check_counts_in_trace(prof, "kernel-form artifact")
            r["launches_in_trace"] = kernel_launches(prof, 1)
            r["device_ms_per_call"] = device_time(prof, 1)[0]
            zero_counts()                            # the export path's run
            for _ in range(EXPORT_WINDOW_CALLS):
                serve(ims, szs)
            counts = (read_counts(), read_captured())
            if counts[0] != expect(per_call, EXPORT_WINDOW_CALLS):
                raise AssertionError(f"{EXPORT_WINDOW_CALLS} artifact calls: launches {counts[0]}")
            art, pb = [], []
            for _ in range(EXPORT_WINDOWS):
                for fn, acc in ((serve, art), (det.predict_batch, pb)):
                    t = time.perf_counter()
                    for _ in range(EXPORT_WINDOW_CALLS):
                        fn(ims, szs)
                    acc.append(batch * EXPORT_WINDOW_CALLS / (time.perf_counter() - t))
            r.update(window_img_per_s=art, img_per_s_median=float(np.median(art)),
                     predict_batch_window_img_per_s=pb,
                     predict_batch_img_per_s_median=float(np.median(pb)))
        else:
            if r["ops"] or any(r["launches_per_call"].values()):
                raise AssertionError(f"plain-form artifact: ops {r['ops']}, launches "
                                     f"{r['launches_per_call']}")
            with dcn_form("plain"), stem_form("plain"):
                want = eager_predict(det, ims, szs)[0].cpu().numpy()
            r["vs_eager_plain_forms"] = compare_dets(got, want, "plain artifact vs eager")
        out[form] = r
        del program, serve
    out["nvidia_smi"] = smi
    emit(out)
    return counts


def phase_converter(det, sd, smi: str) -> dict:
    """The serving weights as a reference ``.pt`` and as a ``.pdparams``
    pickle, converted on the CPU (every leaf bitwise), then served on the
    card by a Detector of their own: detections bit-equal to ``det``'s."""
    import pickle

    import numpy as np
    import torch
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.checkpoint.convert import (convert_paddle_state_dict,
                                                     convert_torch_state_dict,
                                                     load_paddle_state_dict,
                                                     load_torch_state_dict, paddle_names)
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO

    cfg = PPYOLO_2x_Config()
    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    model = PPYOLO.from_config(cfg)
    names = paddle_names(model)
    if sorted(names.values()) != sorted(sd):
        raise AssertionError("the Paddle names do not cover every leaf of ppyolo_2x")
    pt, pdp = EXPORT_DIR / "ppyolo_2x.pt", EXPORT_DIR / "ppyolo.pdparams"
    t0 = time.perf_counter()
    torch.save(sd, pt)
    with open(pdp, "wb") as f:
        pickle.dump({p: sd[k].numpy() for p, k in names.items()}, f, protocol=2)
    t1 = time.perf_counter()
    conv = {"pt": convert_torch_state_dict(load_torch_state_dict(str(pt)), model)}
    t2 = time.perf_counter()
    conv["pdparams"] = convert_paddle_state_dict(load_paddle_state_dict(str(pdp)), model)
    t3 = time.perf_counter()
    for kind, got in conv.items():
        bad = [k for k, v in sd.items() if not torch.equal(got[k], v)]
        if bad or sorted(got) != sorted(sd):
            raise AssertionError(f"{kind}: {len(bad)} leaves differ from the weights: {bad[:5]}")
    rng = np.random.RandomState(41)
    images = rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    sizes = np.tile(np.array([[480, 640]], np.float32), (BATCH, 1))
    want = det.predict_batch(images, sizes)
    served = Detector(PPYOLO.from_config(cfg), conv["pt"], cfg, precision="bf16", device="cuda")
    res = {}
    for kind in ("pt", "pdparams"):
        served.set_params(conv[kind])
        got = served.predict_batch(images, sizes)
        if not np.array_equal(got, want):
            raise AssertionError(f"{kind} weights served on the card differ from the "
                                 f"serving Detector's: max abs {float(np.abs(got - want).max())}")
        res[kind] = {"bitwise": True, "kept": int((got[..., 0] >= 0).sum())}
    out = {"phase": "converter", "model": "ppyolo_2x", "leaves": len(sd),
           "paddle_names": len(names), "write_s": t1 - t0, "convert_pt_s": t2 - t1,
           "convert_pdparams_s": t3 - t2, "pt_bytes": pt.stat().st_size,
           "pdparams_bytes": pdp.stat().st_size, "served": res, "nvidia_smi": smi}
    del served
    for f in (pt, pdp):
        f.unlink()
    emit(out)
    return out


def head_concats(det, images, sizes) -> int:
    """The channel ``torch.cat`` calls of an eager predict that write a
    CoordConv concat (a [B,C,H,W] tensor and [B,2,H,W] planes) or an SPP
    one (four [B,C,H,W] tensors), seen by a ``TorchFunctionMode``."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Cats(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if func is torch.cat and dim in (1, -3):
                self.shapes.append([tuple(t.shape) for t in args[0]])
            return func(*args, **kwargs)

    with Cats() as cats:
        eager_predict(det, images, sizes)
    n = 0
    for s4 in cats.shapes:
        coord = (len(s4) == 2 and len(s4[1]) == 4 and s4[1][1] == 2
                 and s4[0][0] == s4[1][0] and s4[0][2:] == s4[1][2:])
        if coord or (len(s4) == 4 and len(s4[0]) == 4 and len(set(s4)) == 1):
            n += 1
    return n


def head_mode_ab(det, batches, sizes) -> dict:
    """The head's virtual-concat modes on the serving Detector: each mode's
    replay bit-equal to its eager predict; img/s as graph replays in
    HEAD_AB_ROUNDS windows of SERVE_MODE_BATCHES batches, the modes taken
    in turn; device ms by class over 3 replays; the CoordConv and SPP
    concats an eager predict writes."""
    import numpy as np
    from ppyolo_tpu_torch.models.head import AUTO_EVAL_BF16, head_decompose

    res = {}
    for mode in HEAD_MODES:
        with head_decompose(mode):
            graphed_equals_eager(det, batches[0], sizes, f"head mode {mode}")
            det.predict_batch(batches[1], sizes)
    windows = {mode: [] for mode in HEAD_MODES}
    for r in range(HEAD_AB_ROUNDS):
        for mode in (HEAD_MODES if r % 2 == 0 else HEAD_MODES[::-1]):
            with head_decompose(mode):
                windows[mode].append(serve_window(det, batches, sizes,
                                                  SERVE_MODE_BATCHES)["img_per_s"])
    for mode in HEAD_MODES:
        with head_decompose(mode):
            prof = profiled_batches(det, batches, sizes, {"dcn_fwd": 3, "fused_stem": 1},
                                    f"head mode {mode}")
            concats = head_concats(det, batches[0], sizes)
        res[mode] = {"window_img_per_s": windows[mode],
                     "img_per_s_median": float(np.median(windows[mode])),
                     "device_ms_per_batch": prof["device_ms_per_batch"],
                     "by_class": prof["by_class"], "top": prof["top"][:8],
                     "coord_spp_concats_per_batch": concats}
    if res["inner"]["coord_spp_concats_per_batch"] or not res["off"]["coord_spp_concats_per_batch"]:
        raise AssertionError("CoordConv/SPP concats written per batch: "
                             f"{ {m: r['coord_spp_concats_per_batch'] for m, r in res.items()} }")
    return {"modes": res, "rounds": HEAD_AB_ROUNDS, "window_batches": SERVE_MODE_BATCHES,
            "fastest_by_img_per_s": max(HEAD_MODES, key=lambda m: res[m]["img_per_s_median"]),
            "fastest_by_device_ms": min(HEAD_MODES, key=lambda m: res[m]["device_ms_per_batch"]),
            "auto_eval_bf16": AUTO_EVAL_BF16}


def serve_window(det, images, sizes, batches: int) -> dict:
    """img/s and per-batch host ms of ``batches`` graphed predicts."""
    import numpy as np

    lat = []
    t0 = time.perf_counter()
    for i in range(batches):
        t = time.perf_counter()
        out = det.predict_batch(images[i % len(images)], sizes)
        lat.append(time.perf_counter() - t)
        if out.shape != (BATCH, 100, 6) or not np.isfinite(out).all():
            raise AssertionError(f"batch {i}: bad output {out.shape}")
    wall = time.perf_counter() - t0
    return {"batches": batches, "img_per_s": BATCH * batches / wall,
            "batch_ms_median": 1e3 * float(np.median(lat)), "out": out}


def profiled_batches(det, images, sizes, per_batch: dict, where: str) -> dict:
    """Device ms per batch and by class over 3 graphed batches, each port
    kernel's launches per batch from the trace held to ``per_batch``."""
    import torch

    det.predict_batch(images[0], sizes)
    torch.cuda.synchronize()
    zero_counts()
    with device_trace() as prof:
        for i in range(3):
            det.predict_batch(images[i % len(images)], sizes)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, where)
    total, top, by_class = device_time(prof, 3, 12)
    launches = kernel_launches(prof, 3)
    if launches != expect(per_batch, 1):
        raise AssertionError(f"{where}: launches per batch {launches} in the trace")
    return {"device_ms_per_batch": total, "by_class": by_class, "top": top,
            "launches_per_batch": launches}


def graphed_equals_eager(det, images, sizes, where: str):
    import numpy as np

    got = det.predict_batch(images, sizes)
    want = eager_predict(det, images, sizes)[0].cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"{where}: graphed vs eager detections differ, max abs "
                             f"{float(np.abs(got - want).max())}")
    return got


def phase_int8_serving(smi: str):
    """int8 serving of ppyolo_2x@608 b8 (BN calibrated as the serving phase
    does it) through ``Detector(precision="int8")``: every batch one graph
    replay with K1 3, K2 1 and K5 65 launches (counted and in the trace);
    img/s of int8 and bf16 windows in turn (int8, bf16, bf16, int8), device
    ms and idle share of each; graphed bit-equal to eager; ``calibrate`` on
    one batch pins 65 fp32 act scales and releases the graph, the next
    batch captures anew, graphed bit-equal to eager again, the static
    serving timed; and the card's int8 head maps against its bf16 maps
    (identity BN, 2 x 160 px) within INT8_GAP_FACTOR x INT8_BF16_GAP."""
    import numpy as np
    import torch
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.ops.conv import ConvNormAct

    cfg = PPYOLO_2x_Config()
    t0 = time.time()
    model = build_model(cfg, "cuda", SIZE)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    det8 = Detector(model, sd, cfg, precision="int8", device="cuda")
    det16 = Detector(PPYOLO.from_config(cfg), sd, cfg, precision="bf16", device="cuda")
    setup_s = time.time() - t0
    int8_mods = [m for m in det8.model.modules() if isinstance(m, ConvNormAct) and m.conv.is_int8]
    if len(int8_mods) != INT8_CONVS:
        raise AssertionError(f"{len(int8_mods)} int8 convs, want {INT8_CONVS}")
    rng = np.random.RandomState(21)
    images = [rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2)]
    sizes = np.tile(np.array([[480, 640], [608, 608]], np.float32), (BATCH // 2, 1))
    per_batch = {"dcn_fwd": 3, "fused_stem": 1, "conv_int8": INT8_CONVS}

    zero_counts()
    torch.cuda.synchronize()
    serve_window(det8, images, sizes, WARMUP_BATCHES)
    windows = {"int8": [serve_window(det8, images, sizes, INT8_WINDOW_BATCHES)]}
    n_batches = WARMUP_BATCHES + INT8_WINDOW_BATCHES
    launches, captured = read_counts(), read_captured()
    if (launches != expect(per_batch, n_batches + warmup_iters())
            or captured != expect(per_batch, 1)):
        raise AssertionError(f"int8 serving: launch counts {launches}, captured {captured}: "
                             f"want {per_batch} per batch and one captured graph")
    serve_window(det16, images, sizes, WARMUP_BATCHES)
    windows["bf16"] = [serve_window(det16, images, sizes, INT8_WINDOW_BATCHES) for _ in range(2)]
    windows["int8"].append(serve_window(det8, images, sizes, INT8_WINDOW_BATCHES))
    kept = int((windows["int8"][-1]["out"][..., 0] >= 0).sum())
    prof = {"int8": profiled_batches(det8, images, sizes, per_batch, "int8 serving"),
            "bf16": profiled_batches(det16, images, sizes, {"dcn_fwd": 3, "fused_stem": 1},
                                     "bf16 serving")}
    graphed_equals_eager(det8, images[0], sizes, "int8, dynamic scales")

    n = det8.calibrate(images[1])
    if n != INT8_CONVS or det8._graphs:
        raise AssertionError(f"calibrate pinned {n} scales; graphs left {list(det8._graphs)}")
    scales = [m.conv.act_scale for m in int8_mods]
    if any(t.dtype != torch.float32 or t.dim() != 0 for t in scales):
        raise AssertionError("act scales must be 0-d fp32")
    static = serve_window(det8, images, sizes, INT8_WINDOW_BATCHES)
    if [key[0] for key in det8._graphs] != [1]:     # (group, head mode, forms)
        raise AssertionError("no graph was captured after calibrate")
    graphed_equals_eager(det8, images[0], sizes, "int8, static scales")
    prof["int8_static"] = profiled_batches(det8, images, sizes, per_batch, "int8 static")

    # the card's int8 maps against its bf16 maps, identity BN
    x = np.ascontiguousarray(images[0][:2, 200:360, 200:360])
    m0 = build_model(cfg, "cuda")
    sd0 = {k: v.detach().cpu() for k, v in m0.state_dict().items()}
    maps = {}
    for prec, m in (("int8", m0), ("bf16", PPYOLO.from_config(cfg))):
        d = Detector(m, sd0, cfg, precision=prec, device="cuda")
        with torch.no_grad():
            maps[prec] = [o.float() for o in d.model.outputs(d.normalize(
                torch.from_numpy(x).cuda()))]
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(maps["int8"], maps["bf16"])]
    bound = INT8_GAP_FACTOR * INT8_BF16_GAP
    if not all(r <= bound for r in rel):
        raise AssertionError(f"int8 vs bf16 head maps, relative L2 {rel} > {bound}")

    def summary(ws):
        return {"img_per_s": [w["img_per_s"] for w in ws],
                "batch_ms_median": [w["batch_ms_median"] for w in ws]}

    out = {"phase": "int8_serving", "model": "ppyolo_2x", "size": SIZE, "batch": BATCH,
           "int8_convs": INT8_CONVS, "setup_s": setup_s, "launches": launches,
           "captured": captured, "int8": summary(windows["int8"]),
           "bf16": summary(windows["bf16"]), "int8_static": summary([static]),
           "kept_detections_last_batch": kept, "bitwise_graphed_vs_eager": True,
           "bitwise_after_calibrate": True, "calibrated_convs": n,
           "int8_vs_bf16_rel_l2": rel, "int8_vs_bf16_bound": bound, "nvidia_smi": smi,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    for k, p in prof.items():
        ms = float(np.median(out[k]["batch_ms_median"]))
        out[k].update(p, device_idle_share=max(0.0, 1.0 - p["device_ms_per_batch"] / ms))
    emit(out)
    return sd, det8, (launches, captured)


def phase_multiclass(sd, smi: str):
    """The int8 serving model with ``nms_type='multiclass_nms'``: K6 once a
    batch beside K1 3, K2 1 and K5 65 (counted over a warm-up and
    MC_BATCHES replays, and in a trace), graphed bit-equal to eager, img/s
    and device ms."""
    import numpy as np
    import torch
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO

    cfg = PPYOLO_2x_Config()
    cfg.nms_cfg = dict(cfg.nms_cfg, nms_type="multiclass_nms", nms_threshold=0.45)
    det = Detector(PPYOLO.from_config(cfg), sd, cfg, precision="int8", device="cuda")
    rng = np.random.RandomState(31)
    images = [rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2)]
    sizes = np.tile(np.array([[480, 640], [608, 608]], np.float32), (BATCH // 2, 1))
    per_batch = {"dcn_fwd": 3, "fused_stem": 1, "conv_int8": INT8_CONVS, "nms_keep": 1}
    zero_counts()
    torch.cuda.synchronize()
    serve_window(det, images, sizes, 1)
    win = serve_window(det, images, sizes, MC_BATCHES)
    launches, captured = read_counts(), read_captured()
    if (launches != expect(per_batch, 1 + MC_BATCHES + warmup_iters())
            or captured != expect(per_batch, 1)):
        raise AssertionError(f"multiclass serving: launch counts {launches}, captured "
                             f"{captured}: want {per_batch} per batch")
    got = graphed_equals_eager(det, images[0], sizes, "multiclass NMS")
    prof = profiled_batches(det, images, sizes, per_batch, "multiclass serving")
    out = {"phase": "multiclass", "model": "ppyolo_2x", "precision": "int8", "size": SIZE,
           "batch": BATCH, "nms_cfg": cfg.nms_cfg, "launches": launches, "captured": captured,
           "img_per_s": win["img_per_s"], "batch_ms_median": win["batch_ms_median"],
           "kept_detections": int((got[..., 0] >= 0).sum()), "bitwise_graphed_vs_eager": True,
           "device_idle_share": max(0.0, 1.0 - prof["device_ms_per_batch"]
                                    / win["batch_ms_median"]), **prof,
           "nms": multiclass_nms_split(det, images[0], sizes), "nvidia_smi": smi}
    emit(out)
    return launches, captured


def multiclass_nms_split(det, images, sizes) -> dict:
    """The multiclass NMS of one served batch alone, on the decode's own
    outputs (caught from an eager forward): its device ms a batch split into
    K6 and the rest of NMS (torch.profiler over 3 eager calls), its ms in a
    CUDA graph of 20 calls, and no op of it taking a [B, k, k] tensor (the
    profiler's recorded input shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ppyolo_tpu_torch.models import head
    from ppyolo_tpu_torch.tools.kernel_ab import graph_ms

    seen, real = [], head.multiclass_nms
    head.multiclass_nms = lambda b, s, cfg: seen.append((b, s, cfg)) or real(b, s, cfg)
    try:
        eager_predict(det, images, sizes)
    finally:
        head.multiclass_nms = real
    boxes, scores, cfg = seen[0]
    k = min(int(cfg["nms_top_k"]), scores.shape[1] * scores.shape[2])
    run = lambda: real(boxes, scores, cfg)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as shapes:
        run()
        torch.cuda.synchronize()
    kk = sorted({e.key for e in shapes.key_averages(group_by_input_shape=True)
                 if any(len(sh) >= 3 and list(sh[:3]) == [BATCH, k, k] for sh in e.input_shapes)})
    if kk:
        raise AssertionError(f"multiclass NMS: ops on [{BATCH}, {k}, {k}] tensors: {kk}")
    zero_counts()
    with device_trace() as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    if kernel_launches(prof, 3)["nms_keep"] != 1 or read_counts()["nms_keep"] != 3:
        raise AssertionError(f"multiclass NMS: K6 launches {kernel_launches(prof, 3)} a call")
    total, top, _ = device_time(prof, 3, n_top=12)
    k6 = sum(e.self_device_time_total for e in prof.key_averages()
             if "nms_keep_kernel" in e.key) / 1e3 / 3
    return {"k": k, "device_ms_per_batch": total, "k6_device_ms": k6,
            "rest_device_ms": total - k6, "graph_ms": graph_ms(run, 20), "top": top,
            "kk_ops": kk}


def phase_serving_entries(smi: str):
    """``entry.demo`` at int8 on DEMO_IMAGES synthetic jpgs (drawn images
    written, fps and device ms returned) and ``entry.test_dev`` at int8 on
    the same images as a test-dev json (the submission json written and
    parsed), each through its ``main`` with ``--config 0`` pointed at
    ppyolo_2x on the synthetic set; K1, K2 and K5 launched in the ratio of
    a forward (3 : 1 : 65)."""
    import json
    import os
    import shutil

    import numpy as np
    import configs
    from configs import PPYOLO_2x_Config
    from ppyolo_tpu_torch.data.synthetic import make_synthetic_coco
    from ppyolo_tpu_torch.entry import demo, test_dev

    root = REPO / "build" / "chip_smoke_serving"
    shutil.rmtree(root, ignore_errors=True)
    anno, img_dir = make_synthetic_coco(
        str(root / "coco"), DEMO_IMAGES, 80, np.random.RandomState(2),
        image_sizes=((480, 640), (640, 480), (427, 640)), max_objects=6, box_range=(32, 224))
    cfg = PPYOLO_2x_Config()
    cfg.test_path, cfg.test_pre_path = anno, img_dir
    cfg.test_cfg = dict(cfg.test_cfg, model_path=str(root / "missing.npz"), draw_image=True)
    cfg.eval_cfg = dict(cfg.eval_cfg, model_path=str(root / "missing.npz"))
    real = configs.get_config
    configs.get_config = lambda index: cfg
    zero_counts()
    try:
        t0 = time.time()
        got = demo.main(["--config", "0", "--precision", "int8", "--image_dir", img_dir,
                         "--out_dir", str(root / "res")])
        demo_s = time.time() - t0
        t0 = time.time()
        test_dev.main(["--config", "0", "--precision", "int8",
                       "--result_dir", str(root / "eval_results")])
        test_dev_s = time.time() - t0
    finally:
        configs.get_config = real
    launches, captured = read_counts(), read_captured()
    drawn = sorted(os.listdir(root / "res"))
    rows = json.load(open(root / "eval_results" / "bbox_detections.json"))
    ids = {im["id"] for im in json.load(open(anno))["images"]}
    if got["images"] != DEMO_IMAGES or len(drawn) != DEMO_IMAGES or got["fps"] <= 0:
        raise AssertionError(f"demo: {got}, {len(drawn)} drawn")
    if not rows or any(set(r) != {"image_id", "category_id", "bbox", "score"}
                       or r["image_id"] not in ids or len(r["bbox"]) != 4 for r in rows):
        raise AssertionError(f"test_dev json: {len(rows)} rows, first {rows[:1]}")
    k2 = launches["fused_stem"]
    if not k2 or launches["dcn_fwd"] != 3 * k2 or launches["conv_int8"] != INT8_CONVS * k2:
        raise AssertionError(f"entries: launches {launches}")
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "serving_entries", "precision": "int8", "images": DEMO_IMAGES,
          "demo": {k: v for k, v in got.items()}, "demo_s": demo_s, "test_dev_s": test_dev_s,
          "test_dev_rows": len(rows), "drawn": len(drawn), "launches": launches,
          "captured": captured, "nvidia_smi": smi})
    return launches, captured


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
                                  log_fn=lambda i, v, info: logged.append((i, v, info)))
    torch.cuda.synchronize()
    launches, captured = read_counts(), read_captured()
    # one CUDA graph (b8@608), captured at the first step after its eager
    # warm-up run; every step is a replay
    per_step = {"dcn_fwd": 3, "dcn_bwd": 3, **bn_calls(model)}
    if (launches != expect(per_step, n_steps + warmup_iters())
            or captured != expect(per_step, 1)):
        raise AssertionError(f"training launch counts {launches}, captured {captured}: "
                             f"want {per_step} per step and one captured graph")
    if state.step != n_steps or len(edges) != TRAIN_WINDOWS + 1:
        raise AssertionError(f"took {state.step} steps, {len(edges)} window edges")
    if len(logged) != n_steps // TRAIN_WINDOW_STEPS or not all(
            np.isfinite(v) for _, d, _ in logged for v in d.values()):
        raise AssertionError(f"logged losses {logged}")
    step_mfu = check_mfu("fine-tuning", [(info["tflops"], info["mfu"]) for _, _, info in logged])
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
              "logged_losses": [(i, v) for i, v, _ in logged], "mfu_by_log": step_mfu,
              "nvidia_smi": smi,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return state, cfg, host, med, (launches, captured)


def phase_train_profile(state, cfg, host, step_ms: float):
    """Device time by kernel per step over 3 graphed steps of the same loop
    body (H2D of the batch, the replay), K1 and K3 per step from the
    trace, and the idle share against the unprofiled median step time."""
    import torch
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.train.loop import make_unit_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    step_fn = make_unit_step(state.model, cfg, state, gen, compute_dtype=torch.bfloat16)
    state, _ = step_fn(state, host_to_device(host[0], dev), gen)
    torch.cuda.synchronize()
    zero_counts()
    with device_trace() as prof:
        for i in range(3):
            state, _ = step_fn(state, host_to_device(host[i % 2], dev), gen)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, "graphed fine-tuning")
    total, top, by_class = device_time(prof, 3, 30)
    per_step = kernel_launches(prof, 3)
    if per_step != expect({"dcn_fwd": 3, "dcn_bwd": 3, **bn_calls(state.model)}, 1):
        raise AssertionError(f"graphed fine-tuning: launches per step {per_step} in the trace")
    ours = {k: sum(e.self_device_time_total for e in prof.key_averages() if k in e.key) / 3e3
            for k in ("dcn_fwd_kernel", "dcn_bwd_kernel", "dcn_bwd_gather", "bn_train_fwd_stats",
                      "bn_train_fwd_apply", "bn_train_bwd_stats", "bn_train_bwd_dx",
                      "bn_train_reduce")}
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
    import gc

    import numpy as np
    import torch
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
            multi[mode] = unit
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the units the speed forms do not use go before the profiled
        # replays of the live ones (their pools' memory is kept for reuse:
        # train/graphs.py::GraphPool)
        reserved_gb = torch.cuda.memory_reserved() / 1e9
        for mode in ("prescan", "doublebuf"):
            del multi[mode]
        del unit
        gc.collect()
        torch.cuda.empty_cache()

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
            with device_trace() as prof:
                run()
                torch.cuda.synchronize()
            check_counts_in_trace(prof, f"{name} fine-tuning")
            device_ms = device_time(prof, GRAPH_STEPS)[0]
            speed[name] = {"ms_per_step": ms,
                           "enqueue_ms_per_step": 1e3 * float(np.median(enq)) / GRAPH_STEPS,
                           "device_ms_per_step": device_ms,
                           "device_idle_share": max(0.0, 1.0 - device_ms / ms),
                           "launches_per_step": kernel_launches(prof, GRAPH_STEPS)}
            if speed[name]["launches_per_step"] != expect(
                    {"dcn_fwd": 3, "dcn_bwd": 3, **bn_calls(graph_state.model)}, 1):
                raise AssertionError(f"{name}: launches per step "
                                     f"{speed[name]['launches_per_step']}")
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
    out = {"phase": "graphs_training", "model": "ppyolo_2x", "freeze_at": 0, "size": SIZE,
           "batch": BATCH, "precision": "bf16", "steps": GRAPH_STEPS,
           "bitwise_graphed_vs_eager": True, "bitwise_pipelines": list(TARGET_PIPELINES),
           "capture_s_one_step": sum(one.graphs.captures.values()),
           "capture_s_multi": multi_capture, "peak_memory_gb_one_step_graph": one_peak_gb,
           "peak_memory_gb_with_multi_graphs": peak_gb,
           "reserved_gb_before_destroying_two_units": reserved_gb,
           "reserved_gb_after": torch.cuda.memory_reserved() / 1e9,
           "destroyed_units": ["prescan", "doublebuf"], "speed": speed, "nvidia_smi": smi}
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
    per_step = {"dcn_fwd": 3, **cfg_bn_calls(cfg)}
    want = {k: a + b for (k, a), b in zip(
        expect(per_step, train_steps).items(),
        expect({"dcn_fwd": 3, "fused_stem": 1}, n_eval_batches + n_warm).values())}
    want_captured = {k: a + b for (k, a), b in zip(
        expect(per_step, ENTRY_SCAN * n_sizes).items(),
        expect({"dcn_fwd": 3, "fused_stem": 1}, 1).values())}
    if state.step != ENTRY_STEPS or launches != want or captured != want_captured:
        raise AssertionError(f"entry run: {state.step} steps, launches {launches}, captured "
                             f"{captured}; want {want}, {want_captured}")
    if sorted(r["warmup_size"] for r in warm) != sorted(cfg.randomShape["sizes"]):
        raise AssertionError(f"warmup rows {warm}")
    if (len(steps) != ENTRY_STEPS // ENTRY_SCAN
            or not all(np.isfinite(r["total_loss"]) for r in steps)):
        raise AssertionError(f"entry metrics rows {steps}")
    out["mfu_by_row"] = check_mfu("entry metrics.jsonl", [(r["tflops"], r["mfu"]) for r in steps])
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
            with device_trace() as prof:
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
    with device_trace() as prof:
        preloaded_ms = timed(iter(host))
    check_counts_in_trace(prof, "steady steps")
    total, top, by_class = device_time(prof, n_host, 12)
    per_step = kernel_launches(prof, n_host)
    if per_step != expect({"dcn_fwd": 3, **bn_calls(state.model)}, 1):
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


def dist_train_config(drop_block: bool = True):
    """The fine-tuning of ``train_config`` with ``norm_type='sync_bn'``."""
    cfg = train_config()
    cfg.backbone = dict(cfg.backbone, norm_type="sync_bn")
    cfg.head = dict(cfg.head, norm_type="sync_bn", drop_block=drop_block)
    return cfg


def same_on_all_ranks(tensors) -> bool:
    """Are ``tensors`` bitwise rank 0's on every rank of the group?"""
    import torch
    import torch.distributed as tdist

    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    ref = flat.clone()
    tdist.broadcast(ref, 0)
    ok = torch.tensor([float(torch.equal(ref, flat))], device=flat.device)
    tdist.all_reduce(ok, op=tdist.ReduceOp.MIN)
    return bool(ok.item())


def losses_rel(got: dict, want: dict) -> float:
    """Relative L2 of the loss terms (``lr`` left out)."""
    import numpy as np

    keys = [k for k in want if k != "lr"]
    a = np.array([float(got[k]) for k in keys])
    b = np.array([float(want[k]) for k in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_distributed(smi: str):
    """Data parallelism on the one card (``ppyolo_tpu_torch/parallel``).
    NCCL refuses two ranks on one device, so two layouts:

    (a) NCCL at world 1, in this process (``init_from_env`` with a file://
        address): DIST_STEPS graphed fine-tuning steps (``dist_train_config``,
        ``sync_bn``, cuDNN deterministic) bitwise equal to as many without a
        group; the collectives of each step, NCCL's kernels and the
        port's kernels in a replay's trace; the host's ms per unit with and
        without the group; one remat step against the plain one (losses
        within 2e-3, K1 6 a step) and both peaks; then the training entry
        under the group (``--scan_steps 4``, ``warmup_shapes``,
        ``ckpt_backend='orbax'`` -> DCP) resuming bitwise.  The launch
        counters are zeroed as the group starts and read as it ends: the
        ``distributed`` path of the kernels line.
    (b) gloo at world 2 on the same card: two ranks spawned as processes of
        this script (``gloo_rank``), eager (a CUDA graph cannot hold gloo's
        host-staged collectives): GLOO_STEPS steps each on its own batch
        with DropBlock on, params, momentum and EMA bitwise equal on both
        ranks after each; a step with DropBlock off whose losses lie within
        2e-3 of one process's step on the two batches together (b16); then
        ``entry.eval`` on both ranks, whose merged result holds every image
        once and whose 12 stats equal a one-process eval of the same
        weights.  ``make_sharded_predict`` is held under (a) and on the CPU
        (tests): gloo gathers no CUDA tensors.
    """
    import os
    import shutil

    import torch

    torch.backends.cudnn.allow_tf32 = False   # the fp32 b16 reference, as the ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    root = REPO / "build" / "chip_smoke_dist"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    data = entry_dataset(root)
    (root / "data.json").write_text(json.dumps(data))   # the gloo ranks' copy
    out = {"phase": "distributed", "nvidia_smi": smi, "host_cpus": os.cpu_count()}
    out["nccl"], counts = dist_nccl(root, data)
    torch.cuda.empty_cache()
    out["gloo"] = dist_gloo(root, data)
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return counts


def dist_nccl(root: Path, data: dict):
    """Layout (a) of ``phase_distributed``; returns its result and the
    (launches, captured) counts of the group's run."""
    import gc
    import os
    import statistics

    import numpy as np
    import torch
    import torch.distributed as tdist
    from torch.profiler import ProfilerActivity, profile
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.ops.module import BatchNorm
    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = dist_train_config()
    host = [synthetic_train_batch(cfg, 60 + i, BATCH, SIZE) for i in range(DIST_STEPS)]
    batches = [host_to_device(b, dev) for b in host]
    runs = []   # every graph lives until the layout ends

    def graphed(remat=False):
        model = build_model(cfg, "cuda").to(memory_format=torch.channels_last)
        state = init_train_state(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(61)
        unit = GraphedStep(make_train_step(model, cfg, compute_dtype=torch.bfloat16,
                                           remat=remat), state, gen)
        runs.append((state, unit))
        return state, unit

    def replays(state, unit, bs):
        return [{k: v.clone() for k, v in unit(state, b)[1].items()} for b in bs]

    def unit_ms(state, unit):
        """Host ms per unit (one step), each unit waited for, median."""
        times = []
        for i in range(DIST_TIMED_UNITS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unit(state, batches[i % DIST_STEPS])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def eager_peak(state, remat):
        step = make_train_step(state.model, cfg, compute_dtype=torch.bfloat16, remat=remat)
        gen = torch.Generator(device=dev).manual_seed(62)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batches[0], gen)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    def under_group():
        """The run under the group; its graphs go when it returns."""
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        zero_counts()
        gdev = dist.init_from_env(None, init_method=f"file://{root / 'pg_nccl'}")
        if gdev != torch.device("cuda", 0) or dist.backend() != "nccl":
            raise AssertionError(f"group on {gdev} under {dist.backend()}")
        state1, unit1 = graphed()
        got = replays(state1, unit1, batches)
        bad = [(i, k) for i, (g, w) in enumerate(zip(got, want)) for k in w
               if not torch.equal(g[k], w[k])]
        diff = tensors_diff(state1.tensors(), want_state)
        if bad or diff["leaves_differ"]:
            raise AssertionError(f"NCCL world-1 graphed steps differ from no group: losses "
                                 f"{bad[:5]}, state {diff}")
        out["bitwise_group_vs_no_group"] = True
        out["host_ms_per_unit_group"] = unit_ms(state1, unit1)

        # the collectives of one step: the gradient bucket, and each sync-BN
        # layer's statistics forward and backward
        n_bn = sum(isinstance(m, BatchNorm) and m.sync for m in state1.model.modules())
        eager = make_train_step(state1.model, cfg, compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(63)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eager(state1, batches[0], gen)
            torch.cuda.synchronize()
        calls = {e.key: e.count for e in prof.key_averages() if "allreduce" in e.key.lower()}
        out.update(sync_bn_layers=n_bn, allreduce_ops_eager_step=calls,
                   allreduce_ops_want=1 + 2 * n_bn)
        if calls.get("c10d::allreduce_") != 1 + 2 * n_bn:
            raise AssertionError(f"collectives of an eager step {calls}, want "
                                 f"{1 + 2 * n_bn} c10d::allreduce_")
        with device_trace() as prof:
            unit1(state1, batches[0])
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        nccl = [e for e in ev if "nccl" in e.key.lower()]
        out.update(nccl_kernels_per_step=sum(e.count for e in nccl),
                   nccl_device_ms_per_step=sum(e.self_device_time_total for e in nccl) / 1e3,
                   nccl_kernel_names=sorted({e.key[:60] for e in nccl}),
                   device_ms_per_step=device_time(prof, 1)[0],
                   launches_per_step=kernel_launches(prof, 1))
        if out["launches_per_step"] != expect(
                {"dcn_fwd": 3, "dcn_bwd": 3, **bn_calls(state1.model)}, 1):
            raise AssertionError(f"replay under the group: launches {out['launches_per_step']}")

        # remat against the plain step (the first of ``want``)
        before = read_counts(), read_captured()
        state2, unit2 = graphed(remat=True)
        remat_losses = replays(state2, unit2, batches[:1])[0]
        launched = {k: v - before[0][k] for k, v in read_counts().items()}
        recorded = {k: v - before[1][k] for k, v in read_captured().items()}
        out["remat_losses_rel_to_plain"] = losses_rel(remat_losses, want[0])
        out["remat_losses_bitwise"] = all(torch.equal(remat_losses[k], want[0][k])
                                          for k in want[0])
        out["remat_launches"], out["remat_captured"] = launched, recorded
        out["host_ms_per_unit_remat"] = unit_ms(state2, unit2)
        out["host_ms_per_unit_plain_again"] = unit_ms(state1, unit1)
        if out["remat_losses_rel_to_plain"] > 2e-3:
            raise AssertionError(f"remat losses {out['remat_losses_rel_to_plain']} from plain")
        per_step = {"dcn_fwd": 6, "dcn_bwd": 3, **bn_calls(state2.model, remat=True)}
        if (recorded != expect(per_step, 1)
                or launched != expect(per_step, 1 + warmup_iters())):
            raise AssertionError(f"remat step: launches {launched}, captured {recorded}")
        out["peak_gb_eager_step_plain"] = eager_peak(state2, False)
        out["peak_gb_eager_step_remat"] = eager_peak(state2, True)

        # the sharded predict (world 1: the whole batch on this rank)
        det_model = build_model(cfg, "cuda", calib_size=SIZE)
        sd = {k: v.detach().cpu() for k, v in det_model.state_dict().items()}
        detector = Detector(det_model, sd, cfg, precision="bf16", device="cuda")
        ims = np.stack([b["image"][0] for b in host])
        sizes = np.tile(np.array([[SIZE, SIZE]], np.float32), (len(ims), 1))
        if not np.array_equal(detector.predict_sharded(ims, sizes),
                              detector.predict_batch(ims, sizes)):
            raise AssertionError("predict_sharded differs from predict_batch at world 1")
        out["sharded_predict_equal"] = True

        out.update(dist_nccl_entry(root, data))
        launches, captured = read_counts(), read_captured()
        out["launches"], out["captured"] = launches, captured
        missing = [k for k in ("dcn_fwd", "dcn_bwd", "fused_stem") if not launches[k]]
        if missing:
            raise AssertionError(f"the distributed path launched no {missing}: {launches}")
        return launches, captured

    out = {"model": "ppyolo_2x", "freeze_at": 0, "norm": "sync_bn", "batch": BATCH,
           "size": SIZE, "precision": "bf16", "steps": DIST_STEPS}
    bench, det = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    try:
        state0, unit0 = graphed()
        want = replays(state0, unit0, batches)
        want_state = {k: v.clone() for k, v in state0.tensors().items()}
        out["host_ms_per_unit_no_group"] = unit_ms(state0, unit0)

        launches, captured = under_group()
    finally:
        # a live graph that captured NCCL collectives keeps the communicator
        # busy, and destroy_process_group would wait for it forever
        runs.clear()
        gc.collect()
        if dist.active():
            tdist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
    return out, (launches, captured)


def dist_nccl_entry(root: Path, data: dict) -> dict:
    """The training entry under the NCCL group: the recipe with
    ``--scan_steps`` ENTRY_SCAN, ``warmup_shapes`` and
    ``ckpt_backend='orbax'`` (DCP) for DIST_ENTRY_STEPS steps, a DCP step at
    each unit; then DIST_ENTRY_STEPS / 2 steps and a second run that resumes
    from the DCP step, bitwise the straight run (DropBlock off, cuDNN
    deterministic, as ``entry_resume``)."""
    from ppyolo_tpu_torch.checkpoint.dcp_io import DCPCheckpointer
    from ppyolo_tpu_torch.entry.train import run_training

    def cfg_for(**train):
        cfg = entry_config(data, root, **dict(dict(
            max_iters=DIST_ENTRY_STEPS, save_iter=ENTRY_SCAN, eval_iter=10 ** 9, log_iter=1,
            scan_steps=ENTRY_SCAN, ckpt_backend="orbax"), **train))
        cfg.head = dict(cfg.head, drop_block=False)
        return cfg

    t0 = time.time()
    straight = state_arrays(run_training(cfg_for(warmup_shapes=True),
                                         weights_dir=str(root / "dcp_straight")))
    straight_s = time.time() - t0
    steps = DCPCheckpointer(str(root / "dcp_straight" / "dcp")).steps()
    wdir = root / "dcp_resumed"
    run_training(cfg_for(max_iters=DIST_ENTRY_STEPS // 2), weights_dir=str(wdir))
    resumed = state_arrays(run_training(cfg_for(), weights_dir=str(wdir)))
    diff = state_diff(resumed, straight)
    want = list(range(ENTRY_SCAN, DIST_ENTRY_STEPS + 1, ENTRY_SCAN))
    if steps != want or diff["leaves_differ"]:
        raise AssertionError(f"entry under the group: DCP steps {steps} (want {want}), "
                             f"resumed vs straight {diff}")
    rows = read_metrics(root / "dcp_straight")[0]
    return {"entry_steps": DIST_ENTRY_STEPS, "entry_scan_steps": ENTRY_SCAN,
            "entry_run_s_with_warmup_shapes": straight_s, "entry_dcp_steps": steps,
            "entry_resume_bitwise": True,
            "entry_step_ms": [1e3 * r["step_s"] for r in rows],
            "entry_params_npz": str(root / "dcp_straight" / f"step{DIST_ENTRY_STEPS:08d}.npz")}


def dist_gloo(root: Path, data: dict) -> dict:
    """Layout (b) of ``phase_distributed``: the two gloo ranks, then the
    one-process references here."""
    import os
    import subprocess

    import numpy as np
    import torch
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.entry.eval import run_eval
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    init = f"file://{root / 'pg_gloo'}"
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t0 = time.time()
    procs = []
    for r in range(2):
        with open(root / f"gloo{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--gloo-rank", str(r), "2", init,
                 str(root)], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + GLOO_TIMEOUT_S - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    if any(p.returncode for p in procs):
        logs = "".join((root / f"gloo{r}.log").read_text()[-3000:] for r in range(2))
        raise AssertionError(f"gloo ranks exited {[p.returncode for p in procs]}:\n{logs}")
    ranks = [json.loads((root / f"gloo{r}.json").read_text()) for r in range(2)]
    out = {"world": 2, "backend": "gloo", "eager": True, "ranks_s": time.time() - t0,
           "ranks": ranks}
    if not all(all(r["lockstep"]) and len(r["lockstep"]) == GLOO_STEPS for r in ranks):
        raise AssertionError(f"gloo ranks out of lockstep: {[r['lockstep'] for r in ranks]}")

    # one process on the two ranks' first batches together (b16), fp32 as
    # the JAX package's equivalence (tests/test_train.py:202-233): in bf16
    # a rounding flipped by the other summation order moves the losses of
    # this random network by as much as the tolerance
    cfg = dist_train_config(drop_block=False)
    both = {k: np.concatenate([synthetic_train_batch(cfg, gloo_seed(r, 0), BATCH, SIZE)[k]
                               for r in range(2)]) for k in ("image", "gt_bbox", "gt_class",
                                                             "gt_score")}
    model = build_model(cfg, "cuda").to(memory_format=torch.channels_last)
    state = init_train_state(model, cfg)
    _, losses = make_train_step(model, cfg)(state, host_to_device(both, torch.device("cuda")))
    want = {k: float(v) for k, v in losses.items()}
    out["b16_losses"] = want
    out["b16_rel"] = losses_rel(ranks[0]["no_dropblock_losses"], want)
    del model, state
    torch.cuda.empty_cache()
    if out["b16_rel"] > 2e-3:
        raise AssertionError(f"2-rank losses {out['b16_rel']} from the b16 step (> 2e-3)")

    # the eval: rank 0's merged result against one process's
    cfg = gloo_eval_config(data, root)
    one = run_eval(cfg, precision="bf16", result_dir=str(root / "eval_one"))
    merged = json.loads((root / "eval_gloo" / "bbox_detections.json").read_text())
    one_dets = json.loads((root / "eval_one" / "bbox_detections.json").read_text())
    shards = sorted(os.listdir(root / "eval_gloo" / "bbox"))
    want_shards = sorted(f"{im['id']}.json" for im in json.loads(
        Path(cfg.val_path).read_text())["images"])
    out.update(eval_stats=ranks[0]["eval_stats"], eval_stats_one_process=one.tolist(),
               eval_shards=len(shards), eval_rank1_none=ranks[1]["eval_stats"] is None)
    if shards != want_shards or ranks[1]["eval_stats"] is not None:
        raise AssertionError(f"2-rank eval shards {shards}, want {want_shards}; rank 1 "
                             f"returned {ranks[1]['eval_stats']}")
    out["eval_bitwise"] = merged == one_dets and ranks[0]["eval_stats"] == one.tolist()
    if not out["eval_bitwise"]:
        gap = float(np.max(np.abs(np.array(ranks[0]["eval_stats"]) - one)))
        out["eval_stats_max_abs_diff"] = gap
        if gap > 1e-3 or len(merged) != len(one_dets):
            raise AssertionError(f"2-rank eval stats {ranks[0]['eval_stats']} vs one process "
                                 f"{one.tolist()}")
    return out


def gloo_seed(rank: int, step: int) -> int:
    return 80 + 10 * rank + step


def gloo_eval_config(data: dict, root: Path):
    """The entry phase's eval on the params the NCCL entry run saved (its
    model has no DropBlock layers, which would shift the head's paths)."""
    cfg = entry_config({k: tuple(v) for k, v in data.items()}, root)
    cfg.head = dict(cfg.head, drop_block=False)
    cfg.eval_cfg = dict(cfg.eval_cfg, model_path=str(
        root / "dcp_straight" / f"step{DIST_ENTRY_STEPS:08d}.npz"))
    return cfg


def gloo_rank(rank: int, world: int, init: str, root: str) -> int:
    """One rank of ``dist_gloo`` (``chip_smoke.py --gloo-rank RANK WORLD
    INIT ROOT``): a gloo group on cuda:0, eager steps and the eval; writes
    ``ROOT/gloo<rank>.json``."""
    import json
    import statistics

    import torch
    import torch.distributed as tdist

    sys.path.insert(0, str(REPO))
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.entry.eval import run_eval
    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    root = Path(root)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                             timeout=dist.GROUP_TIMEOUT)
    out = {"rank": rank, "lockstep": []}
    zero_counts()

    def run(drop_block, n_steps, dtype):
        cfg = dist_train_config(drop_block)
        model = build_model(cfg, "cuda").to(memory_format=torch.channels_last)
        state = dist.broadcast_state(init_train_state(model, cfg))
        step = make_train_step(model, cfg, compute_dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(71)   # alike on every rank
        losses, times = [], []
        for i in range(n_steps):
            b = host_to_device(synthetic_train_batch(cfg, gloo_seed(rank, i), BATCH, SIZE), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, l = step(state, b, gen)
            losses.append({k: float(v) for k, v in l.items()})
            times.append(1e3 * (time.perf_counter() - t0))
            if drop_block:   # sync_bn: the BN statistics are the same on every rank too
                out["lockstep"].append(same_on_all_ranks(state.tensors().values()))
        return losses, times

    losses, times = run(True, GLOO_STEPS, torch.bfloat16)
    out.update(dropblock_losses=losses, ms_per_step_host_staged=statistics.median(times))
    out["no_dropblock_losses"] = run(False, 1, torch.float32)[0][0]
    torch.cuda.empty_cache()
    data = json.loads((root / "data.json").read_text())
    stats = run_eval(gloo_eval_config(data, root), precision="bf16",
                     result_dir=str(root / "eval_gloo"))
    out["eval_stats"] = None if stats is None else [float(s) for s in stats]
    out["launches"], out["captured"] = read_counts(), read_captured()
    (root / f"gloo{rank}.json").write_text(json.dumps(out))
    tdist.destroy_process_group()
    return 0


def phase_cards(smi: str) -> dict:
    """Data parallelism across every card of the host, one rank a card under
    NCCL (``main`` runs it when there is more than one card; the one-card
    run skips it).  The ranks are spawned as ``chip_smoke.py --card-rank``:

    1. CARDS_STEPS graphed ``sync_bn`` fine-tuning steps a rank
       (``dist_train_config``, b8@608 bf16, DropBlock on, each rank its own
       batches): params, BN statistics, momentum and EMA bitwise equal on
       every rank after each step; NCCL's kernels and their device ms and
       K1/K3 per step in a replay's trace; host ms per unit; then rank 0
       times the same unit on its card without a group (world 1);
    2. the training entry under the group (the recipe with ``--scan_steps
       4`` and ``ckpt_backend='orbax'``, DIST_ENTRY_STEPS steps, a periodic
       eval at the midpoint that rank 0 runs while the others wait in their
       next unit's collectives): every rank ends at the last step with
       params, momentum and EMA equal, rank 0 alone wrote the npz files and
       ``metrics.jsonl``, DCP committed a step at each unit."""
    import os
    import shutil
    import subprocess

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"phase_cards needs more than one card, found {n}")
    root = REPO / "build" / "chip_smoke_cards"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    (root / "data.json").write_text(json.dumps(entry_dataset(root)))
    init = f"file://{root / 'pg_cards'}"
    t0 = time.time()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r))
        with open(root / f"card{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--card-rank", init, str(root),
                 str(CARDS_TIMEOUT_S)], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + CARDS_TIMEOUT_S - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    if any(p.returncode for p in procs):
        logs = "".join((root / f"card{r}.log").read_text()[-3000:] for r in range(n))
        raise AssertionError(f"card ranks exited {[p.returncode for p in procs]}:\n{logs}")
    ranks = [json.loads((root / f"card{r}.json").read_text()) for r in range(n)]
    wdir = root / "entry"
    files = sorted(os.listdir(wdir))
    rows = [json.loads(line) for line in open(wdir / "metrics.jsonl")]
    steps = [r["iter"] for r in rows if "total_loss" in r]
    evals = [r["iter"] for r in rows if "box_ap" in r]
    half = DIST_ENTRY_STEPS // 2
    out = {"phase": "cards", "world": n, "backend": "nccl", "nvidia_smi": smi,
           "ranks_s": time.time() - t0, "ranks": ranks, "entry_files": files,
           "entry_logged_iters": steps, "entry_eval_iters": evals}
    r0 = ranks[0]
    out["img_per_s_world"] = n * BATCH / (r0["host_ms_per_unit"] / 1e3)
    out["img_per_s_one_card"] = BATCH / (r0["host_ms_per_unit_one_card"] / 1e3)
    out["scaling_efficiency"] = out["img_per_s_world"] / (n * out["img_per_s_one_card"])
    emit(out)
    bad = [r["rank"] for r in ranks
           if not (all(r["lockstep"]) and len(r["lockstep"]) == CARDS_STEPS
                   and r["nccl_kernels_per_step"] > 0
                   and r["launches_per_step"] == expect(
                       {"dcn_fwd": 3, "dcn_bwd": 3, **cfg_bn_calls(dist_train_config())}, 1)
                   and r["entry_step"] == DIST_ENTRY_STEPS and r["entry_replicas_equal"]
                   and r["entry_dcp_steps"] == [half, DIST_ENTRY_STEPS])]
    need = {f"step{half:08d}.npz", f"step{DIST_ENTRY_STEPS:08d}.npz", "last_state.npz",
            "metrics.jsonl", "dcp"}
    if bad or not need <= set(files) or evals != [half, DIST_ENTRY_STEPS] or len(steps) != len(
            set(steps)):
        raise AssertionError(f"cards: ranks {bad} failed a gate; files {files}, logged "
                             f"{steps}, evals {evals}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def card_rank(init: str, root: str, timeout_s: float) -> int:
    """One rank of ``phase_cards`` (``chip_smoke.py --card-rank INIT ROOT
    TIMEOUT_S``, with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set);
    writes ``ROOT/card<rank>.json``.  Each stage is logged with its time,
    and a rank still running 60 s before the parent's deadline
    (``TIMEOUT_S``) dumps every thread's stack (``faulthandler``), so a hung
    collective shows where."""
    import faulthandler
    import gc
    import logging
    import os
    import statistics

    import torch
    import torch.distributed as tdist

    sys.path.insert(0, str(REPO))
    from ppyolo_tpu_torch.checkpoint.dcp_io import DCPCheckpointer
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.entry.train import run_training
    from ppyolo_tpu_torch.parallel import dist
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    faulthandler.dump_traceback_later(max(timeout_s - 60, 30))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    t_start = time.time()

    def stage(what):
        print(f"[card {os.environ.get('RANK')}] {time.time() - t_start:.1f}s {what}", flush=True)

    root = Path(root)
    dev = dist.init_from_env(None, init_method=init)
    rank = dist.rank()
    stage(f"group on {dev}")
    cfg = dist_train_config()
    batches = [host_to_device(synthetic_train_batch(cfg, 100 + 10 * rank + i, BATCH, SIZE), dev)
               for i in range(CARDS_STEPS)]

    def graphed():
        model = build_model(cfg, dev).to(memory_format=torch.channels_last)
        state = dist.broadcast_state(init_train_state(model, cfg))
        gen = torch.Generator(device=dev).manual_seed(101)   # alike on every rank
        return state, GraphedStep(make_train_step(model, cfg, compute_dtype=torch.bfloat16),
                                  state, gen)

    def unit_ms(state, unit):
        times = []
        for i in range(CARDS_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            unit(state, batches[i])
            torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    out = {"rank": rank, "device": str(dev), "lockstep": []}
    state, unit = graphed()
    stage("model built and broadcast")
    for i, b in enumerate(batches):
        unit(state, b)
        out["lockstep"].append(same_on_all_ranks(state.tensors().values()))
        stage(f"graphed step {i}")
    out["host_ms_per_unit"] = unit_ms(state, unit)
    stage("timed")
    with device_trace() as prof:
        unit(state, batches[0])
        torch.cuda.synchronize(dev)
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    nccl = [e for e in ev if "nccl" in e.key.lower()]
    out.update(nccl_kernels_per_step=sum(e.count for e in nccl),
               nccl_device_ms_per_step=sum(e.self_device_time_total for e in nccl) / 1e3,
               nccl_kernel_names=sorted({e.key[:60] for e in nccl}),
               device_ms_per_step=device_time(prof, 1)[0],
               launches_per_step=kernel_launches(prof, 1))
    # a live graph that captured NCCL collectives keeps the communicator
    # busy: destroy_process_group waits for it forever
    del state, unit, prof
    gc.collect()
    stage("profiled")
    data = json.loads((root / "data.json").read_text())
    ecfg = entry_config({k: tuple(v) for k, v in data.items()}, root, scan_steps=ENTRY_SCAN,
                        max_iters=DIST_ENTRY_STEPS, save_iter=ENTRY_SCAN,
                        eval_iter=DIST_ENTRY_STEPS // 2, ckpt_backend="orbax")
    t0 = time.time()
    est = run_training(ecfg, weights_dir=str(root / "entry"))
    out.update(entry_s=time.time() - t0, entry_step=est.step,
               entry_replicas_equal=same_on_all_ranks(
                   [v for k, v in est.tensors().items() if "running_" not in k]),
               entry_dcp_steps=DCPCheckpointer(str(root / "entry" / "dcp")).steps())
    del est
    gc.collect()
    stage("entry done")
    tdist.destroy_process_group()
    if rank == 0:   # the same unit on this card alone
        state, unit = graphed()
        unit(state, batches[0])
        out["host_ms_per_unit_one_card"] = unit_ms(state, unit)
    (root / f"card{rank}.json").write_text(json.dumps(out))
    stage("done")
    faulthandler.cancel_dump_traceback_later()
    return 0

def check_mfu(where: str, pairs) -> list:
    """Each (TFLOP/s, MFU) present, above 0, and MFU below 1; returns them."""
    bad = [(t, u) for t, u in pairs if not t or t <= 0 or u is None or not 0 < u < 1]
    if not pairs or bad:
        raise AssertionError(f"{where}: TFLOP/s and MFU {pairs}, want both > 0 and MFU < 1")
    return [{"tflops": t, "mfu": u} for t, u in pairs]


def serving_mfu(det, batch_ms: float, device_ms: float, where: str) -> dict:
    """TFLOP/s and MFU of a served batch from the FLOPs the Detector's graph
    counted on its warm-up run (``utils/mfu.py``): at the served rate (the
    host's median ms a batch) and at the device time alone."""
    from ppyolo_tpu_torch.utils.mfu import mfu, peak_flops_per_chip

    flops = [f for g in det._graphs.values() for f in g.flops.values()]
    if len(flops) != 1:
        raise AssertionError(f"{where}: FLOPs of {len(flops)} graphs, want one")
    f = flops[0]
    out = {"gflop_per_batch": f / 1e9, "peak_tflops": (peak_flops_per_chip() or 0.0) / 1e12}
    pairs = []
    for name, ms in (("served", batch_ms), ("device", device_ms)):
        t, u = f / (ms / 1e3) / 1e12, mfu(f, ms / 1e3)
        out[f"tflops_{name}"], out[f"mfu_{name}"] = t, u
        pairs.append((t, u))
    check_mfu(where, pairs)
    return out


def gn_config(train: bool = False):
    """ppyolo_2x with ``norm_type="gn"`` in the backbone and the head (a copy
    of the config, which itself stays as it is); ``train``: the fine-tuning
    recipe of ``train_config``."""
    from configs import PPYOLO_2x_Config

    cfg = train_config() if train else PPYOLO_2x_Config()
    cfg.backbone = dict(cfg.backbone, norm_type="gn")
    cfg.head = dict(cfg.head, norm_type="gn")
    return cfg


def phase_gn_serving(smi: str):
    """ppyolo_2x-GN serving at b8@608 bf16 (random weights from a seed; GN
    has nothing to fold), each batch a graph replay: K1 3 and K2 0 a batch
    (JAX's stem gate takes BN only), counted and in a trace; the graphed
    predict bitwise the eager forward; on 2 x 160 px the card's bf16 head
    maps no farther (relative L2) from the CPU's fp32 maps than
    GN_GAP_FACTOR x the CPU's bf16 maps are; img/s over GN_WINDOWS
    windows, device ms by class, idle share, TFLOP/s and MFU."""
    import numpy as np
    import torch
    from ppyolo_tpu_torch.eval.detector import Detector

    cfg = gn_config()
    t0 = time.time()
    model = build_model(cfg, "cuda")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if not any(".gn." in k for k in sd) or any(".bn." in k for k in sd):
        raise AssertionError("the GN config built BN layers")
    det = Detector(model, sd, cfg, precision="bf16", device="cuda")
    setup_s = time.time() - t0
    rng = np.random.RandomState(61)
    images = [rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2)]
    sizes = np.tile(np.array([[480, 640], [608, 608]], np.float32), (BATCH // 2, 1))
    per_batch = {"dcn_fwd": 3}
    zero_counts()
    torch.cuda.synchronize()
    serve_window(det, images, sizes, WARMUP_BATCHES)
    windows = [serve_window(det, images, sizes, GN_WINDOW_BATCHES) for _ in range(GN_WINDOWS)]
    n_batches = WARMUP_BATCHES + GN_WINDOWS * GN_WINDOW_BATCHES
    launches, captured = read_counts(), read_captured()
    if (launches != expect(per_batch, n_batches + warmup_iters())
            or captured != expect(per_batch, 1)):
        raise AssertionError(f"GN serving: launch counts {launches}, captured {captured}: "
                             f"want {per_batch} per batch and one captured graph")
    prof = profiled_batches(det, images, sizes, per_batch, "GN serving")
    graphed_equals_eager(det, images[0], sizes, "GN serving")
    ips = [w["img_per_s"] for w in windows]
    batch_ms = float(np.median([w["batch_ms_median"] for w in windows]))
    mfu = serving_mfu(det, batch_ms, prof["device_ms_per_batch"], "GN serving")

    x = np.ascontiguousarray(images[0][:2, 200:360, 200:360])
    maps = {}
    for dev, prec in (("cuda", "bf16"), ("cpu", "bf16"), ("cpu", "fp32")):
        d = det if dev == "cuda" else Detector(build_model(cfg, "cpu"), sd, cfg,
                                               precision=prec, device="cpu")
        with torch.no_grad():
            maps[dev, prec] = [o.double().cpu() for o in d.model.outputs(
                d.normalize(torch.from_numpy(x).to(dev)))]

    def rel_l2(a, b):
        return [float((u - v).norm() / v.norm()) for u, v in zip(maps[a], maps[b])]

    rel = rel_l2(("cuda", "bf16"), ("cpu", "bf16"))
    gaps = {"card_bf16": rel_l2(("cuda", "bf16"), ("cpu", "fp32")),
            "cpu_bf16": rel_l2(("cpu", "bf16"), ("cpu", "fp32"))}
    # GN renormalizes every layer, so bf16 rounding is not damped with depth:
    # each bf16 path lies 2e-2 to 8e-2 from the fp32 maps (measured on an
    # H100), too far for two of them to meet within 2e-2.  The card is held
    # as the model tests hold bf16 paths: no farther from the exact maps
    # than GN_GAP_FACTOR x the CPU's bf16 path.
    if not all(c <= GN_GAP_FACTOR * p for c, p in zip(gaps["card_bf16"], gaps["cpu_bf16"])):
        raise AssertionError(f"GN bf16 head maps' gaps to the CPU's fp32 maps: card "
                             f"{gaps['card_bf16']} > {GN_GAP_FACTOR} x CPU {gaps['cpu_bf16']}")
    med = float(np.median(ips))
    emit({"phase": "gn_serving", "model": "ppyolo_2x", "norm_type": "gn", "size": SIZE,
          "batch": BATCH, "precision": "bf16", "batches": n_batches, "window_img_per_s": ips,
          "window_img_per_s_median": med, "window_spread": (max(ips) - min(ips)) / med,
          "batch_ms_median": batch_ms, "setup_s": setup_s, "launches": launches,
          "captured": captured, "bitwise_graphed_vs_eager": True,
          "card_vs_cpu_rel_l2": rel, "gap_to_cpu_fp32": gaps, **prof,
          "device_idle_share": max(0.0, 1.0 - prof["device_ms_per_batch"] / batch_ms),
          "mfu": mfu, "kept_detections_last_batch": int((windows[-1]["out"][..., 0] >= 0).sum()),
          "nvidia_smi": smi, "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, captured


def phase_gn_training(smi: str):
    """ppyolo_2x-GN fine-tuning (``freeze_at=0``, bf16, EMA, DropBlock,
    b8@608) through ``run_training``, one-step graph replays: K1 3 and K3 3
    a step (the warm-up run's and every replay's), finite logged losses,
    TFLOP/s and MFU of the logged windows; then cuDNN deterministic,
    GN_GRAPH_STEPS graphed steps bitwise as many eager ones from the same
    state and generator; device ms by class of 3 steps; and one fp32 step
    (TF32 off, DropBlock off) at CHECK_SIZE on the card within 2e-3 of the
    CPU path's losses."""
    import numpy as np
    import torch
    from ppyolo_tpu_torch.data.loader import host_to_device
    from ppyolo_tpu_torch.train.graphs import GraphedStep
    from ppyolo_tpu_torch.train.loop import run_training
    from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = gn_config(train=True)
    cfg.train_cfg = dict(cfg.train_cfg, log_iter=GN_TRAIN_STEPS // 2)
    host = [synthetic_train_batch(cfg, seed, BATCH, SIZE) for seed in (0, 1)]
    model = build_model(cfg, "cuda")
    n_steps = TRAIN_WARMUP + GN_TRAIN_STEPS
    edges, logged = [], []

    def mark(st):
        if st.step in (TRAIN_WARMUP, n_steps):
            torch.cuda.synchronize()
            edges.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, eval_sd = run_training(cfg, (host[i % 2] for i in range(n_steps)), device="cuda",
                                  max_iters=n_steps, model=model, after_step=mark,
                                  log_fn=lambda i, v, info: logged.append((i, v, info)))
    torch.cuda.synchronize()
    launches, captured = read_counts(), read_captured()
    per_step = {"dcn_fwd": 3, "dcn_bwd": 3, **bn_calls(model)}
    if (launches != expect(per_step, n_steps + warmup_iters())
            or captured != expect(per_step, 1)):
        raise AssertionError(f"GN training launch counts {launches}, captured {captured}: "
                             f"want {per_step} per step and one captured graph")
    if len(logged) != 2 or not all(np.isfinite(v) for _, d, _ in logged for v in d.values()):
        raise AssertionError(f"GN training logged {logged}")
    if not all(bool(torch.isfinite(v).all()) for v in eval_sd.values()):
        raise AssertionError("GN training: non-finite EMA-applied leaves")
    ms_step = 1e3 * (edges[1] - edges[0]) / GN_TRAIN_STEPS
    step_mfu = check_mfu("GN fine-tuning", [(info["tflops"], info["mfu"])
                                            for _, _, info in logged])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    gen = torch.Generator(device=dev).manual_seed(7)
    step_fn = GraphedStep(make_train_step(state.model, cfg, compute_dtype=torch.bfloat16),
                          state, gen)
    step_fn(state, host_to_device(host[0], dev), gen)
    torch.cuda.synchronize()
    zero_counts()
    with device_trace() as prof:
        for i in range(3):
            step_fn(state, host_to_device(host[i % 2], dev), gen)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, "graphed GN fine-tuning")
    device_ms, top, by_class = device_time(prof, 3, 15)
    if kernel_launches(prof, 3) != expect(per_step, 1):
        raise AssertionError(f"GN fine-tuning: launches per step {kernel_launches(prof, 3)}")
    del state, step_fn, eval_sd, model
    torch.cuda.empty_cache()

    bench, determ = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        batches = [host_to_device(synthetic_train_batch(cfg, 70 + i, BATCH, SIZE), dev)
                   for i in range(GN_GRAPH_STEPS)]
        runs = []
        for capture in (True, False):
            st = init_train_state(build_model(cfg, "cuda").to(memory_format=torch.channels_last),
                                  cfg)
            g = torch.Generator(device=dev).manual_seed(71)
            fn = GraphedStep(make_train_step(st.model, cfg, compute_dtype=torch.bfloat16), st,
                             g, capture=capture)
            losses = [{k: v.clone() for k, v in fn(st, b, g)[1].items()} for b in batches]
            runs.append(({k: v.clone() for k, v in st.tensors().items()}, losses))
            del st, fn
        diff = tensors_diff(runs[0][0], runs[1][0])
        same_losses = all(torch.equal(a[k], b[k]) for a, b in zip(runs[0][1], runs[1][1])
                          for k in a)
        if diff["leaves_differ"] or not same_losses:
            raise AssertionError(f"GN graphed vs eager steps differ: {diff}, losses equal "
                                 f"{same_losses}")
        del runs, batches
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, determ
    torch.cuda.empty_cache()

    check_cfg = gn_config(train=True)
    check_cfg.head = dict(check_cfg.head, drop_block=False)
    check_host = synthetic_train_batch(check_cfg, 3, CHECK_BATCH, CHECK_SIZE)
    losses = {}
    for d in ("cuda", "cpu"):
        m = build_model(check_cfg, d).to(memory_format=torch.channels_last)
        _, lv = make_train_step(m, check_cfg)(init_train_state(m, check_cfg),
                                              host_to_device(check_host, torch.device(d)))
        losses[d] = torch.tensor([float(v) for k, v in lv.items() if k != "lr"],
                                 dtype=torch.float64)
    rel = float((losses["cuda"] - losses["cpu"]).norm() / losses["cpu"].norm())
    if not rel <= 2e-3:
        raise AssertionError(f"GN fp32 step, card vs CPU losses: relative L2 {rel} > 2e-3")
    emit({"phase": "gn_training", "model": "ppyolo_2x", "norm_type": "gn", "freeze_at": 0,
          "size": SIZE, "batch": BATCH, "precision": "bf16", "ema": True, "drop_block": True,
          "steps": n_steps, "ms_per_step": ms_step, "img_per_s": BATCH / (ms_step / 1e3),
          "launches": launches, "captured": captured, "mfu_by_log": step_mfu,
          "logged_losses": [(i, v) for i, v, _ in logged], "device_ms_per_step": device_ms,
          "device_idle_share": max(0.0, 1.0 - device_ms / ms_step), "by_class": by_class,
          "top": top, "bitwise_graphed_vs_eager_steps": GN_GRAPH_STEPS,
          "fp32_losses_card_vs_cpu": rel, "max_memory_allocated_gb": peak_gb,
          "nvidia_smi": smi})
    return launches, captured


def phase_export_int8(det8, smi: str):
    """The calibrated int8 Detector exported in the kernel form at b8: 65
    ``ppyolo::quantized_conv2d``, 3 ``dcn_fwd`` and 1 ``fused_stem`` nodes;
    K5 65, K1 3 and K2 1 launches a call (counted and in a trace); bitwise
    the int8 ``predict_batch``; each call one CUDA graph replay of the
    program, img/s in windows taken in turn with ``predict_batch``'s;
    export, save and load seconds.  Returns the counts of EXPORT_WINDOW_CALLS
    calls (the ``export_int8`` path)."""
    import numpy as np
    import torch
    from ppyolo_tpu_torch.eval.export import (export_detector, load_program, save_serving,
                                              serving_fn)

    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(41)
    ims = rng.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    szs = np.tile(np.array([[480, 640], [608, 608]], np.float32), (BATCH // 2, 1))
    per_call = {"conv_int8": INT8_CONVS, "dcn_fwd": 3, "fused_stem": 1}
    t0 = time.perf_counter()
    data = export_detector(det8, batch=BATCH, dcn="kernel", stem="kernel")
    t1 = time.perf_counter()
    path = EXPORT_DIR / f"ppyolo_2x_{SIZE}_b{BATCH}_int8.pt2"
    save_serving(str(path), data)
    t2 = time.perf_counter()
    program = load_program(path.read_bytes())
    serve = serving_fn(program)
    t3 = time.perf_counter()
    ops = artifact_ops(program)
    if ops != {"quantized_conv2d": INT8_CONVS, "dcn_fwd": 3, "fused_stem": 1}:
        raise AssertionError(f"int8 artifact ops {ops}")
    serve(ims, szs)                                  # the capture
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    zero_counts()
    got = serve(ims, szs)
    if read_counts() != expect(per_call, 1):
        raise AssertionError(f"int8 artifact: launches a call {read_counts()}")
    want = det8.predict_batch(ims, szs)
    if not np.array_equal(got, want):
        raise AssertionError(f"int8 artifact vs predict_batch differ, max abs "
                             f"{float(np.abs(got - want).max())}")
    zero_counts()
    with device_trace() as prof:
        serve(ims, szs)
        torch.cuda.synchronize()
    check_counts_in_trace(prof, "int8 artifact")
    device_ms = device_time(prof, 1)[0]
    zero_counts()                                    # the export_int8 path's run
    for _ in range(EXPORT_WINDOW_CALLS):
        serve(ims, szs)
    counts = (read_counts(), read_captured())
    if counts[0] != expect(per_call, EXPORT_WINDOW_CALLS):
        raise AssertionError(f"{EXPORT_WINDOW_CALLS} int8 artifact calls: launches {counts[0]}")
    art, pb = [], []
    for _ in range(EXPORT_WINDOWS):
        for fn, acc in ((serve, art), (det8.predict_batch, pb)):
            t = time.perf_counter()
            for _ in range(EXPORT_WINDOW_CALLS):
                fn(ims, szs)
            acc.append(BATCH * EXPORT_WINDOW_CALLS / (time.perf_counter() - t))
    emit({"phase": "export_int8", "model": "ppyolo_2x", "size": SIZE, "batch": BATCH,
          "precision": "int8", "scales": "calibrated", "bytes": len(data), "ops": ops,
          "export_s": t1 - t0, "save_s": t2 - t1, "load_s": t3 - t2, "first_call_s": t4 - t3,
          "bitwise_vs_predict_batch": True, "device_ms_per_call": device_ms,
          "window_img_per_s": art, "img_per_s_median": float(np.median(art)),
          "predict_batch_window_img_per_s": pb,
          "predict_batch_img_per_s_median": float(np.median(pb)), "nvidia_smi": smi})
    del program, serve
    return counts


def phase_psroi(smi: str) -> dict:
    """``deform_psroi_pool`` on the card against the CPU at a Deformable
    R-FCN size: a [1, 81*49, 38, 38] map (stride 16 of 608), 300 ROIs,
    pooled, group and part 7, 4 samples a bin, trans_std 0.1,
    class-agnostic offsets [300, 7, 7, 2]: the fp32 forward within 1e-5 of
    the CPU's (max-abs error over max-abs), the gradients of x and the
    offsets within 1e-5 relative L2; forward and backward ms."""
    import torch
    from ppyolo_tpu_torch.ops.deform_psroi_pool import deform_psroi_pool

    gen = torch.Generator().manual_seed(51)
    d, g = PSROI["output_dim"], PSROI["group_size"]
    x = torch.randn(1, d * g * g, PSROI_MAP, PSROI_MAP, generator=gen)
    xy = torch.rand(PSROI_ROIS, 2, generator=gen) * (SIZE - 64)
    wh = 16 + torch.rand(PSROI_ROIS, 2, generator=gen) * 300
    rois = torch.cat([torch.zeros(PSROI_ROIS, 1), xy, (xy + wh).clamp_max(SIZE - 1)], 1)
    trans = torch.randn(PSROI_ROIS, 7, 7, 2, generator=gen) * 0.5
    cot = torch.randn(PSROI_ROIS, d, 7, 7, generator=gen)

    def run(dev, grad=False):
        xs, ts = (t.detach().to(dev).requires_grad_(grad) for t in (x, trans))
        out = deform_psroi_pool(xs, rois.to(dev), ts, **PSROI)
        if grad:
            (out * cot.to(dev)).sum().backward()
            return out, xs.grad, ts.grad
        return out

    cpu, card = run("cpu", True), run("cuda", True)
    err = float((card[0].cpu() - cpu[0]).abs().max() / cpu[0].abs().max())
    grads = [float((a.cpu() - b).norm() / b.norm()) for a, b in zip(card[1:], cpu[1:])]
    if not err <= 1e-5 or not all(r <= 1e-5 for r in grads):
        raise AssertionError(f"psroi card vs CPU: forward {err}, gradients {grads} > 1e-5")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: run("cuda"), 10)
    fwd_bwd_ms = cuda_ms(lambda: run("cuda", True), 5)
    out = {"phase": "psroi", "x": list(x.shape), "rois": PSROI_ROIS, **PSROI,
           "trans": list(trans.shape), "forward_rel_err": err, "grad_rel_l2": grads,
           "forward_ms": fwd_ms, "backward_ms": fwd_bwd_ms - fwd_ms, "nvidia_smi": smi}
    emit(out)
    return out


def phase_profile_serving(smi: str) -> dict:
    """``ppyolo_tpu_torch.tools.profile_serving`` at b8@608 bf16 on the card:
    the stage ablation, the hot kernels and the top convs by time with
    their utilization against the card's peak (``utils/mfu.py``), every
    utilization in (0, 1)."""
    import contextlib
    import io
    from ppyolo_tpu_torch.tools import profile_serving

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = profile_serving.main(["--config", "0", "--batch", str(BATCH), "--size", str(SIZE),
                                    "--precision", "bf16", "--iters", "10", "--top", "12",
                                    "--trace_dir", str(REPO / "build" / "chip_smoke_profile")])
    convs = res["convs"]
    if not convs or not all(c["util"] is not None and 0 < c["util"] < 1 for c in convs):
        raise AssertionError(f"profile_serving conv rows {convs[:5]}")
    out = {"phase": "profile_serving", "ablation_ms": res["ablation_ms"],
           "img_per_s": res["img_per_s"], "peak_tflops": res["peak_flops"] / 1e12,
           "top_convs": convs[:12], "convs_total": res.get("convs_total"),
           "hot": res["hot"][:10], "nvidia_smi": smi}
    emit(out)
    return out


def main() -> int:
    import faulthandler

    faulthandler.enable()   # a crash in native code still shows its Python stack
    try:
        import torch

        begin()
        name, smi = phase_device()
        torch.backends.cudnn.allow_tf32 = False        # fp32 plain versions in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        begin()
        phase_build()
        begin()
        rows = phase_kernels()
        begin()
        counts = {"probe": phase_probe()}
        begin()
        det, sd, images, sizes, batch_ms, counts["serving"] = phase_serving(smi)
        begin()
        phase_profile(det, images, sizes, batch_ms)
        begin()
        phase_graphs_serving(det, sd, smi)
        begin()
        counts["export"] = phase_export(det, smi)
        begin()
        phase_converter(det, sd, smi)
        del det
        torch.cuda.empty_cache()
        begin()
        sd8, det8, counts["int8_serving"] = phase_int8_serving(smi)
        begin()
        counts["export_int8"] = phase_export_int8(det8, smi)
        del det8
        begin()
        counts["multiclass"] = phase_multiclass(sd8, smi)
        del sd8
        begin()
        counts["serving_entries"] = phase_serving_entries(smi)
        torch.cuda.empty_cache()
        begin()
        state, cfg, host, step_ms, counts["training"] = phase_training(smi)
        begin()
        phase_train_profile(state, cfg, host, step_ms)
        del state
        torch.cuda.empty_cache()
        begin()
        phase_graphs_training(smi)
        torch.cuda.empty_cache()
        begin()
        phase_train_check()
        torch.cuda.empty_cache()
        begin()
        counts["gn_serving"] = phase_gn_serving(smi)
        torch.cuda.empty_cache()
        begin()
        counts["gn_training"] = phase_gn_training(smi)
        torch.cuda.empty_cache()
        begin()
        phase_psroi(smi)
        begin()
        phase_profile_serving(smi)
        torch.cuda.empty_cache()
        begin()
        counts["entry"] = phase_entry(smi)
        torch.cuda.empty_cache()
        begin()
        counts["distributed"] = phase_distributed(smi)
        if torch.cuda.device_count() > 1:
            begin()
            phase_cards(smi)
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
    row = rows["bn_train_fwd"]   # K7's row counts its forward; its backward beside it
    row["bwd_launches_by_path"] = {path: c[0]["bn_train_bwd"] for path, c in counts.items()}
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:   # one rank of the distributed phase's layout (b)
        sys.exit(gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--card-rank"]:   # one rank of phase_cards
        sys.exit(card_rank(sys.argv[2], sys.argv[3], float(sys.argv[4])))
    sys.exit(main())
