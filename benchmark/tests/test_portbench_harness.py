"""The harness end to end on the CPU against the tiny stand-in
configuration (``tiny.json``), with the output check shown to fail the
faults a cell can have."""
import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import serve, train

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
TINY = json.loads((HERE / "tiny.json").read_text())
SERVE_LIMITS = {"box_err_med": 0.01, "image_err_max": 0.02, "nms_miss": 0.02,
                "nms_score_gap_med": 1e-3}
TRAIN_LIMITS = {"grad_gap_med": 1e-3, "step_gap_med": 1e-3, "step_gap_total": 1e-3,
                "ema_gap_med": 1e-3, "bn_gap_med": 1e-3, "loss_gap_max": 1e-3}


def serve_traffic(frames):
    return {"runner": "serve", "batch": 1 if frames else 2, "size": 64, "pool": 3,
            "frames": frames, "im_sizes": [[48, 64], [64, 48], [40, 60]], "warmup_calls": 1,
            "trace_units": 2, "check_calls": 2}


TRAIN_TRAFFIC = {"runner": "train", "batch": 2, "size": 64, "pool": 4, "max_boxes": 50,
                 "boxes": 4, "freeze_at": 0, "check_steps": 3,
                 "trace_units": 1}


def report(out, limits, traced=False):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.report(out, {"chips": 1, "limits": limits},
                        types.SimpleNamespace(trace=int(traced)))
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ppyolo_2x.serve_b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text("{}")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ppyolo_2x.serve_b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("frames", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_serving_runs_end_to_end_and_is_correct(frames, traced):
    out = serve.run(TINY, serve_traffic(frames), 2 ** 33 + 5, 0.3, traced, time.time(),
                    device="cpu")
    res = report(out, SERVE_LIMITS, traced)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if traced:
        assert "breakdown" in res and "busy_s" in res["device"]
        assert ("preprocess_ms.serve" in res["metrics"]) == frames
    else:
        assert set(res["metrics"]) == {"serve_img_per_s", "serve_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer", "no_nms_decay"])
def test_serving_faults_fail_the_check(fault):
    out = serve.run(TINY, serve_traffic(False), 2 ** 33 + 5, 0.3, False, time.time(),
                    device="cpu", fault=fault)
    assert not report(out, SERVE_LIMITS)["correct"]


def test_serving_control_fails_the_check():
    """The program's int8 path in its place (the control of a bf16 cell;
    here against the fp32 stand-in's limits)."""
    out = serve.run(TINY, serve_traffic(False), 2 ** 33 + 5, 0.3, False, time.time(),
                    device="cpu", precision="int8")
    assert not report(out, SERVE_LIMITS)["correct"]


def test_training_control_fails_the_check():
    """The reference in fp8 put in the program's place."""
    out = train.run(TINY, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.2, False, time.time(), device="cpu",
                    precision="fp8")
    assert not report(out, TRAIN_LIMITS)["correct"]


def test_training_runs_end_to_end_and_is_correct():
    out = train.run(TINY, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.5, True, time.time(), device="cpu")
    res = report(out, TRAIN_LIMITS, traced=True)
    assert res["correct"] and res["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "ema_unchanged"])
def test_training_faults_fail_the_check(fault, monkeypatch):
    """A step that leaves its state unchanged, that steps on half of the
    batch, or that leaves the EMA shadow unchanged, planted under the
    program's unit of work."""
    from ppyolo_tpu_torch.train import loop, train_step

    if fault == "ema_unchanged":
        monkeypatch.setattr(train_step, "ema_update", lambda *a, **k: None)

    made = loop.make_unit_step

    def broken(model, cfg, state, generator, **kw):
        unit = made(model, cfg, state, generator, **kw)

        def step(st, batch, gen=None):
            if fault == "ema_unchanged":
                return unit(st, batch, gen)
            if fault == "unchanged":
                st.step += 1
                return st, {"total_loss": torch.tensor(1.0)}
            return unit(st, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, gen)
        return step

    monkeypatch.setattr(loop, "make_unit_step", broken)
    out = train.run(TINY, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.2, False, time.time(), device="cpu")
    assert not report(out, TRAIN_LIMITS)["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "ema_unchanged"])
def test_reference_placed_faults_fail_the_check(fault):
    """The reference with a fault put in the program's place
    (``tools/control.py``'s training faults)."""
    out = train.run(TINY, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.2, False, time.time(), device="cpu",
                    fault=fault)
    assert not report(out, TRAIN_LIMITS)["correct"]


def test_bf16_witness_reads_its_leaves():
    """The reference in bf16 put in the program's place reads every leaf
    group, and names each group's worst leaf."""
    out = train.run(TINY, TRAIN_TRAFFIC, 2 ** 33 + 9, 0.2, False, time.time(), device="cpu",
                    precision="bf16")
    r = out["readings"]
    assert set(r["worst"]) == {"grad", "step", "ema", "bn"}
    assert 0 < r["grad_gap_med"] <= r["grad_gap_max"]
