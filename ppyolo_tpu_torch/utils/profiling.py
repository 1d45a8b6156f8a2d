"""Profiling: torch.profiler traces, their summaries, per-conv utilization,
a synced timer, and the port's host spans (``ppyolo_tpu/utils/profiling.py``).

``trace(logdir)`` records the CPU and (on a card) CUDA activity of its
block with shapes and FLOPs and writes a chrome trace into ``logdir``;
``summarize_trace`` and ``trace_op_times`` read it back.  The JAX package
credits conv FLOPs to the trace's instruction names by parsing the
optimized HLO; the port has no HLO, so ``conv_flops_from_profile`` takes
the FLOPs torch.profiler itself computes for each conv and matrix-product
op (``with_flops=True``) and credits them to the device kernel the op
launched (its longest), or on the CPU to the op.  ``device_time`` and
``cuda_ms`` are ``chip_smoke.py``'s device-time readers.

Spans.  ``span(name, **attrs)`` marks a stretch of host work at a layer
boundary of the port (the serving call's stage, upload, launch and fetch,
the training loop's feed and step, a graph capture).  Only a
``recording()`` block turns them on: it yields a ``Recording`` that keeps,
in memory, every span closed inside it (name, id, parent, root, start and
end on ``time.time_ns``, the epoch clock on which torch.profiler's kineto
records stand, so spans and device records share one clock) and the
``device_allocs`` counter.  Outside one, ``span`` returns one shared
no-op object after a single test of a module-level variable: no clock is
read and nothing is kept.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MATMUL_OPS = ("aten::conv2d", "aten::mm", "aten::addmm", "aten::bmm")
TRACE_LEAD_S = 0.05     # idle seconds at each end of a device trace's window


@contextlib.contextmanager
def device_trace(*activities, **kwargs):
    """torch.profiler over CUDA activity (or ``activities``) whose window
    holds TRACE_LEAD_S of idle time before and after the caller's work.
    Yields the profiler.

    The profiler keeps only the device records that fall inside its window,
    and it places them by a device clock that can run milliseconds off the
    host's: on an H100 80GB HBM3 (700 W) with torch 2.11 and CUDA 12.8,
    graph replays' kernels were found stamped up to 5.2 ms before the
    ``cudaGraphLaunch`` call that launched them.  A replay launched ~2 ms
    after a bare window opened then lost its first kernels from the trace
    in 6 of 397 sessions of 3 served batches; with a lead of 5 ms or 50 ms
    none of 397 sessions each lost one.  The idle tail keeps the same
    margin at the close."""
    from torch.profiler import ProfilerActivity, profile

    def settle():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(TRACE_LEAD_S)

    with profile(activities=list(activities) or [ProfilerActivity.CUDA], **kwargs) as prof:
        settle()
        yield prof
        settle()


@contextlib.contextmanager
def trace(logdir: str = os.path.join("build", "trace")):
    """torch.profiler over the block (CPU, and CUDA where a card is
    present; shapes and FLOPs recorded), its chrome trace written to
    ``logdir/trace.json`` at the end.  Yields the profiler."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with device_trace(*acts, record_shapes=True, with_flops=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _events(logdir: str):
    for f in glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True):
        with open(f) as fh:
            for ev in json.load(fh).get("traceEvents", []):
                if ev.get("ph") == "X" and "dur" in ev:
                    yield ev


def _device_event(ev) -> bool:
    return ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")


def trace_op_times(logdir: str) -> Dict[str, float]:
    """{name: total_ms} of every device kernel, copy and memset in the trace,
    or of every CPU op where it ran none: the join key of
    ``conv_utilization_table``."""
    evs = list(_events(logdir))
    device = [e for e in evs if _device_event(e)]
    dur: "collections.Counter[str]" = collections.Counter()
    for ev in device or [e for e in evs if e.get("cat") == "cpu_op"]:
        dur[ev.get("name", "?")] += ev["dur"]
    return {k: v / 1000.0 for k, v in dur.items()}


def summarize_trace(logdir: str, top: int = 25):
    """[(name, total_ms)] of ``trace_op_times`` by time descending: the
    quick hot-op view."""
    return sorted(trace_op_times(logdir).items(), key=lambda kv: -kv[1])[:top]


def _kernels_under(ev):
    out = list(getattr(ev, "kernels", []) or [])
    for child in ev.cpu_children:
        out += _kernels_under(child)
    return out


def conv_flops_from_profile(prof) -> Dict[str, Tuple[float, str]]:
    """{name: (flops, 'NxCxHxW * CoxCxKhxKw + ...')} of the profiler's conv
    and matrix-product ops (their own ``with_flops`` count), each credited
    to the longest device kernel it launched, or where it launched none
    (the CPU) to the op's name; ops sharing a kernel sum."""
    out: Dict[str, Tuple[float, str]] = {}
    for ev in prof.events():
        if ev.name not in MATMUL_OPS or not ev.flops:
            continue
        ks = _kernels_under(ev)
        name = max(ks, key=lambda k: k.duration).name if ks else ev.name
        shapes = ev.input_shapes[:2] if ev.input_shapes else []
        label = " * ".join("x".join(str(d) for d in s) for s in shapes)
        f0, l0 = out.get(name, (0.0, ""))
        out[name] = (f0 + float(ev.flops), f"{l0} + {label}" if l0 else label)
    return out


def conv_utilization_table(times: Dict[str, float], convs: Dict[str, Tuple[float, str]], *,
                           peak: float, repeat: int = 1):
    """Join trace times with conv FLOPs -> (rows of (ms, util, flops,
    shape, name) by time descending, the number of conv names).  The
    traced work ran the FLOPs of ``convs`` ``repeat`` times (the JAX
    package's HLO parse becomes ``conv_flops_from_profile``)."""
    rows = []
    for name, ms in times.items():
        if name in convs and ms > 0:
            fl, shape = convs[name]
            rows.append((ms, fl * repeat / (ms / 1e3) / peak, fl * repeat, shape, name))
    return sorted(rows, key=lambda r: -r[0]), len(convs)


def _sync(device=None) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def timeit_sync(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean wall seconds a call of ``fn(*args)``, the card synchronized
    before and after the timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def cuda_ms(fn: Callable, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events over ``iters`` warm calls."""
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


KERNEL_CLASSES = (   # (class, substrings of the kernel name), first match wins
    ("port_kernels", ("dcn_fwd_kernel", "dcn_bwd_kernel", "dcn_bwd_gather",
                      "fused_stem_kernel", "conv_s2_", "conv_int8_kernel", "nms_keep_kernel",
                      "bn_train_")),
    ("conv_gemm", ("xmma", "nvjet", "cutlass", "gemm", "cudnn", "dgrad", "wgrad")),
    ("copy_memset", ("Memcpy", "Memset", "copy_kernel", "CatArray")),
    ("elementwise_reduce", ("at::native",)),
)


def busy_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Time in which at least one interval runs: overlaps count once."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy


def device_time(prof, units: int, n_top: int = 25):
    """(device ms per unit, the n_top kernels by device time per unit, ms
    per unit by KERNEL_CLASSES) of a torch.profiler run over ``units``
    batches or steps.  The first is the union of the device records'
    intervals, so kernels that overlap (graph branches, side streams) count
    once; the per-kernel and per-class times are sums."""
    from torch.autograd import DeviceType

    records = [(r.start_ns(), r.start_ns() + r.duration_ns())
               for r in prof.profiler.kineto_results.events() if r.device_type() == DeviceType.CUDA]
    total = busy_ns(records) / 1e6 / units
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:n_top]
    by_class: Dict[str, float] = {}
    for e in ev:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3 / units
    return total, [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3 / units,
                    "calls": e.count / units} for e in top], by_class


class Recording:
    """What one ``recording()`` block kept: ``spans``, each a ``Span`` in the
    order they closed, and ``counters``: ``device_allocs``, the caching
    allocator's device allocations (``num_device_alloc``) from the block's
    opening to its close, where it was given a CUDA device."""

    def __init__(self):
        self.spans: List["Span"] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)


class Span:
    """One span of an open recording.  ``parent`` is the id of the span
    open around it on its thread when it opened (None for a root), ``root``
    the id of the outermost of those (its own for a root); ``start_ns`` and
    ``end_ns`` from ``time.time_ns``."""
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns", "_rec")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = _open_spans()
        self.id = next(self._rec._ids)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (None, self.id)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        _open_spans().pop()
        self._rec.spans.append(self)
        self._rec = None    # no cycle through the recording
        return None

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"{(self.end_ns - self.start_ns) / 1e3:.1f} us, {self.attrs})")


class _NoSpan:
    """The span every site gets while no recording is open: does nothing.
    A site skips work done only for a span's attrs when it holds this one."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


NO_SPAN = _NoSpan()
_RECORDING: Optional[Recording] = None     # the open recording, if any
_THREAD = threading.local()                # .stack: the thread's open spans


def _open_spans() -> list:
    stack = getattr(_THREAD, "stack", None)
    if stack is None:
        stack = _THREAD.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager over one stretch of host work named ``name``,
    kept with ``attrs`` by the open ``recording()``; ``NO_SPAN`` when none
    is open.  Yields the span (its ``attrs`` dict can take more keys)."""
    if _RECORDING is None:
        return NO_SPAN
    return Span(_RECORDING, name, attrs)


def _device_allocs(device: torch.device) -> int:
    return int(torch.cuda.memory_stats(device).get("num_device_alloc", 0))


@contextlib.contextmanager
def recording(device=None):
    """Keep the spans of the block, and on a CUDA ``device`` its
    ``device_allocs``: yields the block's ``Recording``.  One recording
    is open at a time."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("a recording is already open")
    device = torch.device(device) if device is not None else None
    on_card = device is not None and device.type == "cuda"
    allocs = _device_allocs(device) if on_card else 0
    rec = _RECORDING = Recording()
    try:
        yield rec
    finally:
        _RECORDING = None
        if on_card:
            rec.counters["device_allocs"] = _device_allocs(device) - allocs
