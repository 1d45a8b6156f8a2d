"""The traced block of a ``--trace 1`` run: a profiler window held in
memory, its device records as intervals, and the arithmetic on them.

``device_trace`` is a frozen copy of the program's
``utils/profiling.py::device_trace``: the profiler keeps only the device
records that fall inside its window and places them by a device clock
that ran up to 5.2 ms off the host's on the H100 machine, so the window
idles ``LEAD_S`` at each end.  Records stay in memory (no chrome trace is
written); ``device_records`` turns them into ``(name, start_ns, end_ns)``
on the host's epoch clock (``time.time_ns``), which the benchmark's own
spans use too.

``KERNEL_CLASSES`` is a frozen copy of the program's table of kernel
classes (first match wins).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

LEAD_S = 0.05
KERNEL_CLASSES = (
    ("port_kernels", ("dcn_fwd_kernel", "dcn_bwd_kernel", "dcn_bwd_gather",
                      "fused_stem_kernel", "conv_s2_", "conv_int8_kernel", "nms_keep_kernel")),
    ("conv_gemm", ("xmma", "nvjet", "cutlass", "gemm", "cudnn", "dgrad", "wgrad")),
    ("copy_memset", ("Memcpy", "Memset", "copy_kernel", "CatArray")),
    ("elementwise_reduce", ("at::native",)),
)

Interval = Tuple[str, int, int]


@contextlib.contextmanager
def device_trace():
    """torch.profiler over CUDA activity (CPU activity on a machine without
    a card, for the harness's own tests), idle ``LEAD_S`` at each end of
    the caller's block.  Yields the profiler.  Host activity is not traced:
    recording every host op slows the host side of each call, which the
    idle share would then count; the benchmark's own spans name the gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def settle():
        if cuda:
            torch.cuda.synchronize()
        time.sleep(LEAD_S)

    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        settle()
        yield prof
        settle()


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def device_records(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device records, host records) of a finished profiler, each
    ``(name, start_ns, end_ns)`` sorted by start."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = _ns(ev, "end") if hasattr(ev, "end_ns") else start + int(ev.duration_ns())
        (dev if ev.device_type() == DeviceType.CUDA else host).append((ev.name(), start, end))
    return sorted(dev, key=lambda r: r[1]), sorted(host, key=lambda r: r[1])


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted ``[(start, end)]`` covering the same time."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(records: Sequence[Interval]) -> int:
    """Time in which at least one record runs (overlaps counted once)."""
    return sum(e - s for s, e in union([(r[1], r[2]) for r in records]))


def span_ns(records: Sequence[Interval]) -> int:
    """From the first record's start to the last one's end."""
    if not records:
        return 0
    return max(r[2] for r in records) - min(r[1] for r in records)


def kernel_class(name: str) -> str:
    return next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")


def matching(records: Sequence[Interval], keys: Sequence[str]) -> List[Interval]:
    return [r for r in records if any(k in r[0] for k in keys)]


def breakdown(dev: Sequence[Interval], spans: Dict[str, List[Tuple[int, int]]],
              host: Sequence[Interval], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the longest idle gaps
    between device records, each gap named by the benchmark span (else the
    host record) under its midpoint: ``[[name, seconds], ...]``."""
    by_name: Dict[str, int] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0) + e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(r[1], r[2]) for r in dev])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)[:top]
    named = []
    for g, s, e in gaps:
        mid = (s + e) // 2
        inner = [(b - a, k) for k, iv in spans.items() for a, b in iv if a <= mid <= b]
        label = f"span:{min(inner)[1]}" if inner else None
        if label is None:
            label = next((f"host:{n}" for n, a, b in reversed(host) if a <= mid <= b), "untracked")
        named.append([label, g / 1e9])
    return {"device_ops": [[n[:120], t / 1e9] for n, t in ops], "idle_gaps": named}
