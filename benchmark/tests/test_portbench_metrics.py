"""The per-layer readers and the end-to-end arithmetic over hand-made records."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import serve, trace

BENCH = Path(__file__).resolve().parents[1]
MS = 1_000_000   # ns


def record(kind="serve", dev=(), **kw):
    rec = dict(kind=kind, chips=1, device_name="NVIDIA H100 80GB HBM3", units=1, steps=1,
               images=8, dev=list(dev), host=[], spans={},
               window_s=trace.span_ns(list(dev)) / 1e9, flops_per_image=1e11,
               dcn_layers=[dict(n=8, c=512, h=19, w=19, co=512, oh=19, ow=19, k2=9)])
    rec.update(kw)
    return rec


def test_overlapping_kernels_are_counted_once_in_device_idle():
    dev = [("a", 0, 6 * MS), ("b", 2 * MS, 8 * MS), ("c", 9 * MS, 10 * MS)]
    idle = run.readers()["device_idle.serve"].read(record(dev=dev))
    assert idle == pytest.approx(10.0)   # busy 0-8 and 9-10 of a 10 ms window


def test_p95_is_over_all_calls():
    lat = [0.010 if i % 17 == 0 else 0.001 for i in range(100)]   # 6 slow calls, spread
    assert serve.p95_ms(lat) == pytest.approx(10.0)
    chunk_medians = [np.median(lat[i:i + 10]) for i in range(0, 100, 10)]
    assert np.quantile(chunk_medians, 0.95) * 1e3 == pytest.approx(1.0)


@pytest.mark.parametrize("name,kind", [("dcn_fwd_roofline.serve", "serve"),
                                       ("dcn_bwd_roofline.train", "train"),
                                       ("preprocess_ms.serve", "serve"),
                                       ("collective_ms.train", "train")])
def test_a_reader_whose_records_are_absent_returns_none(name, kind):
    rec = record(kind=kind, dev=[("at::native::elementwise_kernel", 0, MS)])
    assert run.readers()[name].read(rec) is None


def test_collectives_count_only_the_exchange_no_other_record_covers():
    dev = [("ncclDevKernel_AllReduce_Sum_f32", 0, 4 * MS), ("sm90_xmma_gemm", 1 * MS, 2 * MS),
           ("at::native::add", 3 * MS, 6 * MS), ("ncclDevKernel_AllReduce_Sum_f32", 7 * MS, 8 * MS)]
    rec = record(kind="train", dev=dev, steps=2)
    assert run.readers()["collective_ms.train"].read(rec) == pytest.approx(1.5)   # 3 ms, 2 steps


def test_rooflines_and_mfu_read_from_their_kernels():
    dev = [("dcn_fwd_kernel<...>", 0, 2 * MS), ("at::native::x", 2 * MS, 10 * MS)]
    rs = run.readers()
    share = rs["dcn_fwd_roofline.serve"].read(record(dev=dev))
    assert 0 < share < 100
    assert rs["mfu.serve"].read(record(dev=dev)) == pytest.approx(
        100 * 8 * 1e11 / 0.010 / 989e12)
    assert rs["mfu.serve"].read(record(dev=dev, device_name="cpu")) is None
    assert rs["elementwise_ms.serve"].read(record(dev=dev)) == pytest.approx(1.0)


def test_new_metric_and_workload_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH / "metrics", tmp_path / "metrics")
    (tmp_path / "metrics" / "new_thing.serve.py").write_text(
        "UNIT = 'ms'\n\ndef read(rec):\n    return 1.5\n")
    found = run.readers(tmp_path / "metrics")
    assert found["new_thing.serve"].read({}) == 1.5
    assert set(run.readers()) < set(found)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / "ppyolo_2x.new_cell.json").write_text('{"config": "ppyolo_2x"}')
    assert run.load_json("workloads", "ppyolo_2x.new_cell", tmp_path)["config"] == "ppyolo_2x"
