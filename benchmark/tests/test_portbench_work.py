"""Work counts of the benchmark against the program's own numbers."""
import json
from pathlib import Path

import pytest

from benchmark.reference import model as ref
from benchmark.work import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def fields(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["fields"]


def test_ppyolo_2x_forward_count_agrees_with_the_ports():
    """The port counted 815.2 GFLOP a b8@608 batch (its FlopCounterMode run
    plus K1's formula).  The reference counts the CoordConv channels' FLOPs
    for every image, where the served head computes their term once per
    grid for the whole batch, so it reads ~0.1% more."""
    w = counts.model_flops(ref, fields("ppyolo_2x"), 608, 8)
    assert w["flops"] == pytest.approx(815.2e9, rel=2e-3)
    assert w["flops"] >= 815.2e9


def test_kernel_bounds_are_chip_smokes():
    w = counts.model_flops(ref, fields("ppyolo_2x"), 608, 8)
    assert len(w["dcn_layers"]) == 3
    k1 = sum(counts.dcn_fwd_bound(layer, H100) for layer in w["dcn_layers"])
    k3 = sum(counts.dcn_bwd_bound(layer, H100) for layer in w["dcn_layers"])
    assert k1 * 1e3 == pytest.approx(0.0413, abs=1e-4)
    assert k3 * 1e3 == pytest.approx(0.0638, abs=1e-4)


def test_r18vd_has_no_dcn_and_training_counts_more():
    f = fields("ppyolo_r18vd")
    fwd = counts.model_flops(ref, f, 416, 1)
    assert fwd["dcn_layers"] == []
    assert counts.model_flops(ref, f, 416, 1, train=True)["flops"] > 2 * fwd["flops"]
