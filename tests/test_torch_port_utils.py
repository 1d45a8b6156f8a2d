"""The port's ``utils`` (logger, MFU, profiling) against the JAX package's
``ppyolo_tpu/utils``, on the CPU: the cases of ``tests/test_mfu.py`` and
``tests/test_profiling.py``, mirrored.

FLOPs: JAX adds each non-interpreted Pallas kernel's ``CostEstimate`` to
XLA's cost analysis; the port adds each launched kernel's formula
(``utils/mfu.py``) to ``FlopCounterMode``'s count.  Each formula equals the
mode's count of the kernel's plain version at the same shape, so on the
CPU, where the plain versions run, the mode's count is the program's.
"""
import json
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from ppyolo_tpu.ops.conv import dcn_impl
from ppyolo_tpu.ops.deform_conv_pallas import deform_conv2d_fast
from ppyolo_tpu.utils.logger import TrainMeter as JaxTrainMeter
from ppyolo_tpu.utils.logger import setup_logger as jax_setup_logger
from ppyolo_tpu.utils.mfu import custom_call_flops

from ppyolo_tpu_torch.entry import train as train_entry
from ppyolo_tpu_torch.ops.conv_int8 import quantized_conv2d_plain
from ppyolo_tpu_torch.ops.deform_conv import dcn_bwd_plain, deform_conv2d, deform_conv2d_plain
from ppyolo_tpu_torch.ops.matrix_nms import nms_keep_boxes_plain
from ppyolo_tpu_torch.ops.stem import fused_stem_plain
from ppyolo_tpu_torch.ops.strided_conv import conv_s2_phase
from ppyolo_tpu_torch.utils import logger, mfu, profiling

from test_torch_port_entry import METRIC_KEYS, dataset, entry_cfg  # noqa: F401  (fixture)


def _aten(fn, *args, **kwargs) -> float:
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    return float(mode.get_total_flops())


def test_program_flops_counts_matmul():
    n = 256
    a = torch.zeros(n, n)
    flops = mfu.program_flops(lambda: a @ a)
    assert abs(flops - 2 * n ** 3) / (2 * n ** 3) < 0.05


def test_mfu_handles_unknown_peak(monkeypatch):
    assert mfu.peak_flops_per_chip("cpu") is None
    assert mfu.mfu(1e12, 0.1, device="cpu") is None
    assert mfu.mfu(None, 0.1) is None
    # the CPU's peak is unknown; a known one gives the fraction
    monkeypatch.setattr(mfu, "peak_flops_per_chip", lambda device=None: 197e12)
    assert mfu.mfu(9.85e12, 0.1) == pytest.approx(0.5)
    assert mfu.mfu(9.85e12, 0.1, n_chips=2) == pytest.approx(0.25)


def _dcn_args(dtype=torch.float32):
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(1, 16, 8, 8).astype(np.float32)).to(dtype)
    w = torch.from_numpy(r.randn(32, 16, 3, 3).astype(np.float32) * 0.1).to(dtype)
    om = torch.from_numpy(r.randn(1, 27, 8, 8).astype(np.float32) * 0.5).to(dtype)
    return x, w, om


def test_kernel_flops_lists_the_dcn_kernels_of_a_grad_program():
    """A DCN grad program reaches dcn_fwd and dcn_bwd once each, here as
    their plain versions (``launched=False``), as JAX's registry lists its
    two Pallas kernels (interpreted on the CPU).  The counts differ: JAX's
    CostEstimate counts its one-hot form, 2 N k^2 Pp C (Qp + Co) with the
    pixels and the one-hot width padded to 64 and 128; the port counts the
    [P, k^2 C] x [k^2 C, Co] product, 2 P k^2 C Co, and K3 as no matrix
    work (the products around it are aten matmuls)."""
    x, w, om = (t.requires_grad_() for t in _dcn_args())

    def grad_program():
        deform_conv2d(x, w, om, stride=1, padding=1).sum().backward()

    got = mfu.kernel_flops(grad_program)
    assert got == [("dcn_fwd", 2.0 * 64 * 9 * 16 * 32, False), ("dcn_bwd", 0.0, False)]

    jx = jnp.ones((1, 8, 8, 16), jnp.float32)
    jw = jnp.ones((3, 3, 16, 32), jnp.float32)
    joff, jm = jnp.zeros((1, 8, 8, 18), jnp.float32), jnp.zeros((1, 8, 8, 9), jnp.float32)
    with dcn_impl("pallas"):
        found = custom_call_flops(jax.grad(lambda *a: deform_conv2d_fast(*a).sum(),
                                           argnums=(0, 1, 2, 3)), jx, jw, joff, jm)
    assert sorted(n for n, _, _ in found) == ["_bwd_kernel", "_kernel"]
    assert dict((n, f) for n, f, _ in found)["_kernel"] == 2 * 1 * 9 * 64 * 16 * (128 + 32)

    # on the CPU nothing launched: the program's count is the mode's alone
    assert mfu.program_flops(grad_program) == _aten(grad_program) > 0


def test_each_kernel_formula_is_the_count_of_its_plain_version():
    """K1-K5's formulas against FlopCounterMode's count of the plain
    version at a small shape (odd sizes and both strides where the kernel
    takes them); K6's plain version does no matrix work, and its formula
    is 0."""
    r = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(r.randn(*s).astype(np.float32))  # noqa: E731
    # K1, stride 1 and 2
    for stride, h in ((1, 9), (2, 11)):
        oh = (h - 1) // stride + 1
        x, w, om = t(2, 8, h, h), t(12, 8, 3, 3), t(2, 27, oh, oh)
        assert _aten(deform_conv2d_plain, x, w, om, stride=stride, padding=1) == \
            mfu.dcn_fwd_flops(2, oh, oh, 9, 8, 12)
        # K3: per-element sums only
        dm = t(2 * oh * oh, 9 * 8)
        assert _aten(dcn_bwd_plain, x, om, dm, ksize=(3, 3), stride=stride, padding=1) == \
            mfu.dcn_bwd_flops(2, oh, oh, 9, 8) == 0
    # K2 at an odd size
    x = t(2, 3, 37, 42)
    ws = [t(32, 3, 3, 3), t(32), t(32, 32, 3, 3), t(32), t(64, 32, 3, 3), t(64)]
    assert _aten(fused_stem_plain, x, *ws) == mfu.fused_stem_flops(2, 37, 42)
    # K4
    x, w = t(2, 16, 12, 12), t(24, 16, 3, 3)
    assert _aten(conv_s2_phase, x, w) == mfu.conv_s2_flops(2, 6, 16, 24)
    # K5: 1x1 and 3x3, stride 1 and 2
    for k, stride in ((1, 1), (3, 1), (3, 2)):
        x = t(2, 40, 10, 10)
        wq = torch.from_numpy(r.randint(-127, 128, (24, 40, k, k)).astype(np.int8))
        ho = (10 + 2 * ((k - 1) // 2) - k) // stride + 1
        assert _aten(quantized_conv2d_plain, x, wq, t(24).abs(), stride=stride,
                     padding=(k - 1) // 2) == mfu.conv_int8_flops(2, ho, ho, 24, 40, k)
    # K6
    valid = torch.ones(2, 50, dtype=torch.bool)
    boxes = torch.rand(2, 50, 4)
    boxes[..., 2:] += boxes[..., :2]
    labels = torch.from_numpy(r.randint(0, 3, (2, 50)))
    assert _aten(nms_keep_boxes_plain, valid, boxes, labels, 0.5) == mfu.nms_keep_flops() == 0


def test_counting_leaves_the_result_alone():
    x, w, om = _dcn_args()
    want = deform_conv2d(x, w, om)
    with mfu.counting() as c:
        got = deform_conv2d(x, w, om)
    assert torch.equal(got, want)
    assert c.total == c.aten == mfu.dcn_fwd_flops(1, 8, 8, 9, 16, 32)
    assert c.kernels == [("dcn_fwd", mfu.dcn_fwd_flops(1, 8, 8, 9, 16, 32), False)]


def test_conv_flops_from_profile_and_the_utilization_join(tmp_path):
    """torch.profiler's own conv FLOPs are 2 N Ho Wo Co Cin k^2 (stride 2
    here), credited on the CPU to the op; the join scales by ``repeat`` and
    divides by the trace's time and the peak, as the JAX table does."""
    x, w = torch.randn(2, 16, 20, 20), torch.randn(32, 16, 3, 3)
    with profiling.trace(str(tmp_path)) as prof:
        F.conv2d(x, w, stride=2, padding=1)
    convs = profiling.conv_flops_from_profile(prof)
    want = 2.0 * 2 * 10 * 10 * 32 * 16 * 9
    assert convs["aten::conv2d"] == (want, "2x16x20x20 * 32x16x3x3")
    times = profiling.trace_op_times(str(tmp_path))
    assert times["aten::conv2d"] > 0
    assert any(name == "aten::conv2d" for name, _ in profiling.summarize_trace(str(tmp_path)))
    rows, n = profiling.conv_utilization_table({"aten::conv2d": 2.0, "unrelated": 9.0}, convs,
                                               peak=100e12, repeat=4)
    assert n == 1 and len(rows) == 1
    ms, util, fl, shape, name = rows[0]
    assert (ms, fl, name) == (2.0, 4 * want, "aten::conv2d")
    np.testing.assert_allclose(util, 4 * want / (2.0 / 1e3) / 100e12)


def test_timeit_sync_times_calls():
    calls = []
    s = profiling.timeit_sync(lambda v: calls.append(v), 1, iters=5, warmup=2)
    assert len(calls) == 7 and s >= 0


def test_device_trace_keeps_the_work_clear_of_the_window_ends(monkeypatch):
    """The caller's work starts TRACE_LEAD_S after the window opens, the
    window stays open TRACE_LEAD_S after it, and the trace holds it."""
    import time

    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(profiling, "TRACE_LEAD_S", 0.02)
    with profiling.device_trace(ProfilerActivity.CPU) as prof:
        torch.ones(8).mul(3)
        done = time.perf_counter()
    closed = time.perf_counter()
    results = prof.profiler.kineto_results
    ops = [e for e in results.events() if e.name() == "aten::mul"]
    assert len(ops) == 1
    assert ops[0].start_ns() - results.trace_start_ns() >= 0.02e9
    assert closed - done >= 0.02


def test_train_meter_and_logger_match_jax():
    ours, theirs = logger.TrainMeter(window=3), JaxTrainMeter(window=3)
    for dt in (0.5, 0.25, 1.0, 2.0, 0.125):
        ours.update(dt)
        theirs.update(dt)
        assert ours.avg == theirs.avg
        assert ours.imgs_per_sec(8) == theirs.imgs_per_sec(8)
        assert ours.eta_hours(1000) == theirs.eta_hours(1000)
    assert logger.TrainMeter().avg == JaxTrainMeter().avg == 0.0
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        for h in list(root.handlers):
            root.removeHandler(h)
        jax_setup_logger()
        want = root.handlers[0].formatter
        root.removeHandler(root.handlers[0])
        assert logger.setup_logger().name == "ppyolo_tpu_torch"
        got = root.handlers[0].formatter
        assert (got._fmt, got.datefmt) == (want._fmt, want.datefmt)
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)


def test_entry_writes_tflops_and_logs_eta(dataset, tmp_path, caplog):  # noqa: F811
    """The training entry's metrics rows carry the JAX entry's keys: tflops
    counted (as JAX's cost analysis counts on the CPU), mfu null where the
    peak is unknown; the log line is the JAX entry's, eta included."""
    cfg = entry_cfg(dataset, max_iters=2, save_iter=10, eval_iter=10)
    wdir = str(tmp_path / "w")
    with caplog.at_level(logging.INFO, logger="ppyolo_tpu_torch.train.loop"):
        train_entry.run_training(cfg, weights_dir=wdir, device="cpu")
    rows = [json.loads(line) for line in open(os.path.join(wdir, "metrics.jsonl"))]
    steps = [r for r in rows if "total_loss" in r]
    assert len(steps) == 2
    for r in steps:
        assert set(r) == METRIC_KEYS
        assert r["tflops"] > 0 and r["mfu"] is None
    lines = [rec.getMessage() for rec in caplog.records if rec.getMessage().startswith("iter ")]
    assert len(lines) == 2
    for line in lines:
        assert "imgs/s, " in line and "TFLOP/s" in line and "mfu" not in line
        assert line.rstrip().endswith("h") and ", eta " in line


def test_profile_serving_tool_on_the_cpu(tmp_path):
    """``tools/profile_serving`` (the JAX tool's counterpart) at r18vd 64 px
    b1 on the CPU: the three stages timed, the hot ops and the conv table
    from the trace; the conv FLOPs of one forward are FlopCounterMode's
    count of the same forward (every conv and matrix product), and with no
    known peak there is no utilization."""
    import configs

    from ppyolo_tpu_torch.eval.detector import Detector
    from ppyolo_tpu_torch.models import PPYOLO
    from ppyolo_tpu_torch.tools import profile_serving

    out = profile_serving.main(["--config", "1", "--batch", "1", "--size", "64", "--use_gpu",
                                "false", "--precision", "fp32", "--iters", "2",
                                "--profile_iters", "1", "--trace_dir", str(tmp_path)])
    assert set(out["ablation_ms"]) == {"backbone", "head", "full"}
    assert out["hot"] and out["peak_flops"] is None
    assert out["convs"] and all(c["util"] is None for c in out["convs"])
    cfg = configs.get_config(1)
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    det = Detector(model, model.state_dict(), cfg, target_size=64, device="cpu")
    x = det.normalize(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    want = _aten(det.model.predict, x, torch.tensor([[480.0, 640.0]]))
    assert sum(c["gflop"] for c in out["convs"]) * 1e9 == pytest.approx(want, rel=1e-9)
