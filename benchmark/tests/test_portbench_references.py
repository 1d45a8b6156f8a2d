"""A configuration names its plain reference: the runners, the weights,
both output checks and the FLOP count take the module it names, a name
with no module ends the run before any card work, and the tiny
configuration's numbers through the default module are those the harness
gave before the module was chosen by name (pinned bitwise from that
harness on one CPU thread; another torch build may round otherwise)."""
import collections
import hashlib
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark.harness import serve, train, weights
from benchmark.reference import compare, for_config
from benchmark.reference import model
from benchmark.work import counts

from .test_portbench_harness import TINY, TRAIN_TRAFFIC, serve_traffic

ROOT = Path(__file__).resolve().parents[2]
STUBBED = ("param_shapes", "Net", "normalize", "detect", "targets", "loss")


@pytest.fixture
def stub(monkeypatch):
    """``benchmark.reference.stub_arch``: the default module's functions,
    each counting its calls."""
    calls = collections.Counter()
    mod = types.ModuleType("benchmark.reference.stub_arch")
    mod.__dict__.update({k: v for k, v in vars(model).items() if not k.startswith("__")})

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    for name in STUBBED:
        setattr(mod, name, counted(name, getattr(model, name)))
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return dict(TINY, reference="stub_arch"), calls


def test_default_module_is_the_v1_reference():
    assert for_config(TINY) is model


def test_serving_weights_check_and_flops_use_the_named_module(stub):
    cfg_file, calls = stub
    out = serve.run(cfg_file, serve_traffic(False), 2 ** 33 + 5, 0.2, True, time.time(),
                    device="cpu")
    assert out["readings"]["nms_miss"] == 0.0
    assert out["record"]["flops_per_image"] > 0
    assert calls["param_shapes"] and calls["detect"]
    assert calls["Net"] >= 2      # the calibration and the FLOP count


def test_training_check_uses_the_named_module(stub):
    cfg_file, calls = stub
    out = train.run(cfg_file, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.1, False, time.time(),
                    device="cpu", precision="bf16")
    assert out["readings"]["grad_gap_med"] > 0
    assert calls["targets"] and calls["loss"]
    assert calls["Net"] >= 1 + 2 * TRAIN_TRAFFIC["check_steps"]


def test_an_unknown_reference_exits_before_any_card_work(tmp_path):
    with pytest.raises(SystemExit, match="benchmark/reference/no_such_arch.py"):
        for_config({"reference": "no_such_arch"})
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "configs" / "stray.json").write_text(json.dumps(dict(TINY, reference="no_such_arch")))
    (bench / "workloads" / "stray.serve_b8.json").write_text(
        json.dumps({"config": "stray", "traffic": "serve_b8", "chips": 1, "limits": {}}))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "stray.serve_b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "benchmark/reference/no_such_arch.py" in p.stderr
    assert "CUDA card" not in p.stderr


# -- the tiny configuration's numbers, pinned -------------------------------------

SD_SHA256 = "6c0a030c5f7ab149bdb5f0a9313898da7b2107688814e2d21aab639287ec8b21"
FLOPS = {(64, 2, False): 1455521792.0, (64, 2, True): 4363026432.0,
         (608, 8, True): 1575052541952.0}
SERVE_READINGS = {"box_err_med": 3.576278118089249e-07, "image_err_max": 4.768370445162873e-07,
                  "nms_miss": 0.0, "nms_score_gap_med": 1.083416094616041e-07}
BF16_READINGS = {"bn_gap_med": 0.00017249633316834535, "ema_gap_med": 0.0039341457444904,
                 "grad_gap_med": 0.0322910805510738, "step_gap_med": 0.01195229552345058,
                 "step_gap_total": 0.0013057528079947953,
                 "loss_gap_max": 0.0005007273352786203}


@pytest.fixture
def one_thread():
    """The pins were taken on one CPU thread: more split the sums otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_weights_flops_and_readings_are_pinned(one_thread):
    cfg = TINY["fields"]
    P = weights.make_state_dict(model, cfg, 2 ** 33 + 1, torch.device("cpu"), 64)
    h = hashlib.sha256()
    for k in sorted(P):
        h.update(k.encode())
        h.update(P[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == SD_SHA256
    for (size, batch, tr), flops in FLOPS.items():
        assert counts.model_flops(model, cfg, size, batch, train=tr)["flops"] == flops
    t = dict(serve_traffic(False), pool=2)
    det, P, _, pool = serve.setup(model, TINY, t, 2 ** 33 + 5, torch.device("cpu"), "fp32")
    calls = [{"images": b["images"], "im_size": b["im_size"],
              "out": det.predict_batch(b["images"], b["im_size"])} for b in pool]
    assert compare.judge(model, cfg, P, calls, torch.device("cpu")) == SERVE_READINGS
    out = train.run(TINY, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.1, False, time.time(), device="cpu",
                    precision="bf16")
    got = {k: out["readings"][k] for k in BF16_READINGS}
    assert got == BF16_READINGS
