"""The port's host spans (``utils/profiling.py``: ``span``, ``recording``)
at the sites that carry them, and ``device_time``'s union of device records.

CPU only: a fake step function over the CPU ``DevicePrefetcher``, a mini-2x
``Detector`` at 64 px, a CPU profiler beside a span.  The graph spans
(``graph.refresh``, ``graph.upload``, ``graph.launch``) are on the card
path alone: ``tests/test_torch_port_gpu.py`` holds them to the profiler's
``cudaGraphLaunch`` records.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from benchmark.harness.trace import device_records
from ppyolo_tpu_torch.data.loader import DevicePrefetcher
from ppyolo_tpu_torch.eval.detector import Detector
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.train.graphs import Graphs, shape_key
from ppyolo_tpu_torch.train.loop import step_loop
from ppyolo_tpu_torch.utils import profiling
from test_torch_port_train import mini2x_cfg


def _batches(n):
    r = np.random.RandomState(0)
    return [{"image": r.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
             "gt_bbox": r.rand(2, 5, 4).astype(np.float32)} for _ in range(n)]


def _fake_step(state, unit, generator):
    state.step += 1
    return state, {"total_loss": unit["image"].float().mean()}


def _loop(n_batches):
    state = SimpleNamespace(step=0)
    units = DevicePrefetcher(iter(_batches(n_batches)), torch.device("cpu"))
    return step_loop(state, _fake_step, units, None, max_iters=100, log_every=0)


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_off_return_the_shared_no_op_keep_nothing_and_read_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span site read the clock with no recording open")

    monkeypatch.setattr(profiling, "time", SimpleNamespace(time_ns=no_clock))
    assert profiling.span("train.feed") is profiling.NO_SPAN
    assert profiling.span("serve.stage", bytes=3) is profiling.NO_SPAN
    with profiling.span("x") as sp:
        assert sp is profiling.NO_SPAN
    assert _loop(3).step == 3
    Graphs(lambda inp: {"y": inp["x"] * 2}, "cpu").prepare({"x": torch.ones(3)})
    assert profiling._RECORDING is None
    assert getattr(profiling._THREAD, "stack", []) == []


def test_step_loop_spans_nest_under_one_root_per_unit():
    """Each unit: ``train.unit`` the root, ``train.feed`` (holding
    ``feed.host`` and ``feed.upload``, the latter with the unit's bytes) and
    ``train.step`` its children, every span inside its parent's interval;
    the last ``train.feed`` finds no batch and no step follows."""
    with profiling.recording() as rec:
        state = _loop(3)
    assert state.step == 3 and rec.counters == {}
    by_id = {s.id: s for s in rec.spans}
    roots = {}
    for s in rec.spans:
        roots.setdefault(s.root, []).append(s)
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
            assert p.root == s.root
    assert len(roots) == 4
    want_parent = {"train.feed": "train.unit", "train.step": "train.unit",
                   "feed.host": "train.feed", "feed.upload": "train.feed", "train.unit": None}
    for i, (root, spans) in enumerate(sorted(roots.items())):
        names = sorted(s.name for s in spans)
        if i < 3:
            assert names == sorted(want_parent), names
        else:
            assert names == ["feed.host", "train.feed", "train.unit"], names
        for s in spans:
            parent = by_id[s.parent].name if s.parent is not None else None
            assert parent == want_parent[s.name], s
    b = _batches(1)[0]
    assert [s.attrs for s in _by_name(rec)["feed.upload"]] == [
        {"bytes": b["image"].nbytes + b["gt_bbox"].nbytes}] * 3


def test_detector_records_call_stage_fetch_and_resize():
    """A CPU Detector (the eager path): ``predict_batch`` gives a
    ``serve.call`` root holding ``serve.stage`` (the staged bytes) and
    ``serve.fetch``; ``detect_image`` adds ``serve.resize`` before its
    call."""
    cfg = mini2x_cfg()
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), cfg, target_size=64, device="cpu")
    r = np.random.RandomState(1)
    images = r.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[480, 640], [64, 64]], np.float32)
    frame = r.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    with profiling.recording() as rec:
        det.predict_batch(images, sizes)
        det.detect_image(frame)
    names = _by_name(rec)
    calls = names["serve.call"]
    assert len(calls) == 2 and all(c.parent is None for c in calls)
    for child in ("serve.stage", "serve.fetch"):
        assert [s.parent for s in names[child]] == [c.id for c in calls], child
    assert [s.attrs["bytes"] for s in names["serve.stage"]] == [
        images.nbytes + sizes.nbytes, 64 * 64 * 3 + 8]
    (resize,) = names["serve.resize"]
    assert resize.parent is None and resize.end_ns <= calls[1].start_ns


def test_span_holds_the_profilers_record_on_one_clock(monkeypatch):
    """A span and the profiler's record of the op inside it, as the
    benchmark's ``device_records`` reads it, stand on one clock."""
    monkeypatch.setattr(profiling, "TRACE_LEAD_S", 0.01)
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiling.device_trace(ProfilerActivity.CPU) as prof, profiling.recording() as rec:
        with profiling.span("mm"):
            torch.mm(a, b)
    _, host = device_records(prof)
    (mm,) = [r for r in host if r[0] == "aten::mm"]
    (sp,) = rec.spans
    assert sp.start_ns <= mm[1] <= mm[2] <= sp.end_ns


def _span_other():
    with profiling.span("other"):
        pass


def test_recording_one_at_a_time_threads_root_apart_and_capture_keyed():
    """A second ``recording()`` inside one raises; a span opened on another
    thread is a root of its own; ``graph.capture`` carries its shape key;
    an exception leaves the span recorded and the stack empty."""
    g = Graphs(lambda inp: {"y": inp["x"] * 2}, "cpu")
    x = {"x": torch.ones(3)}
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.recording():
                pass
        with profiling.span("outer") as outer:
            t = threading.Thread(target=_span_other)
            t.start()
            t.join(10)
            assert not t.is_alive()
            g.prepare(x)
        with pytest.raises(KeyError):
            with profiling.span("raises"):
                raise KeyError("x")
    names = _by_name(rec)
    (other,) = names["other"]
    assert other.parent is None and other.root == other.id
    (cap,) = names["graph.capture"]
    assert cap.parent == outer.id and cap.attrs == {"key": shape_key(x)}
    assert [s.name for s in names["raises"]] == ["raises"]
    assert profiling._THREAD.stack == [] and profiling._RECORDING is None


class _Kineto:
    def __init__(self, dev, start_us, end_us):
        self._dev, self._s, self._d = dev, int(start_us * 1e3), int((end_us - start_us) * 1e3)

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_device_time_counts_overlapping_kernels_once():
    """Two kernels overlapping by 5 us and one apart: the total is the
    union of their intervals (20 us), the per-kernel and per-class times
    stay sums (25 us); host records count for nothing."""
    from torch.autograd import DeviceType

    records = [_Kineto(DeviceType.CUDA, 0, 10), _Kineto(DeviceType.CUDA, 5, 15),
               _Kineto(DeviceType.CUDA, 20, 25), _Kineto(DeviceType.CPU, 0, 100)]
    averages = [SimpleNamespace(key="void at::native::add_kernel", self_device_time_total=15.0,
                                count=2),
                SimpleNamespace(key="sm90_xmma_gemm", self_device_time_total=10.0, count=1),
                SimpleNamespace(key="cudaLaunchKernel", self_device_time_total=0.0, count=3)]
    prof = SimpleNamespace(key_averages=lambda: averages,
                           profiler=SimpleNamespace(kineto_results=SimpleNamespace(
                               events=lambda: records)))
    total, top, by_class = profiling.device_time(prof, units=2)
    assert total == 0.010
    assert [(t["name"], t["ms"], t["calls"]) for t in top] == [
        ("void at::native::add_kernel", 0.0075, 1.0), ("sm90_xmma_gemm", 0.005, 0.5)]
    assert by_class == {"elementwise_reduce": 0.0075, "conv_gemm": 0.005}
    assert profiling.busy_ns([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
