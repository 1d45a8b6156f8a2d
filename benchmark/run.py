"""Run one cell of the port's benchmark once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``benchmark/workloads/<cell>.json``
(its configuration, traffic, chips and the limits of its output check),
the configuration in ``benchmark/configs/<config>.json`` (with the plain
reference module it names, ``benchmark/reference/<name>.py``), the traffic mix
in ``benchmark/traffic/<traffic>.json`` (whose ``runner`` names the module
``benchmark/harness/<runner>.py`` that drives the program), and with
``--trace 1`` every per-layer metric in ``benchmark/metrics/<metric>.py``
(a reader that finds nothing to read returns None and its metric is left
out of the line).

It measures ``ppyolo_tpu_torch`` on CUDA cards only: without a card, or
with fewer than the cell asks for, it exits 2 and prints no result.  The
last stdout line is the result; the output check's numbers beside their
limits come last in it and as the last lines of stderr.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ppyolo_tpu")   # top-level module names, compared whole


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                         f"({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def readers(directory: Path = HERE / "metrics") -> dict:
    """{metric name: reader module} of every file in ``metrics/``."""
    out = {}
    for f in sorted(directory.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"_metric_{f.stem}", f)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[f.stem] = mod
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def loaded_jax(who: str = "the run") -> bool:
    """Whether this process holds JAX or the JAX package; names them on
    stderr if it does."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: {who} loaded {bad}; the port must not use JAX or the JAX "
              "package", file=sys.stderr, flush=True)
    return bool(bad)


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ.setdefault("USE_FLAX", "0")


def device_ok(chips: int) -> bool:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), this machine has {n}; "
              "it measures the port on cards only", file=sys.stderr)
        return False
    return True


def quiet_host() -> None:
    """One CPU thread for torch's and OpenCV's host work: the runs share the
    machine's cores with other work, and a pool of threads then waits for
    its slowest one."""
    import cv2
    import torch

    torch.set_num_threads(1)
    cv2.setNumThreads(1)


def listed(workload: str) -> set:
    """The metrics ``BENCHMARK.json`` lists for ``workload`` (all of them
    where there is no such file, as in the harness's own tests)."""
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        return None
    b = json.loads(path.read_text())
    return {m["name"] for m in b["end_to_end"] + b["per_layer"]
            if workload in m.get("workloads", [workload])}


def checks(readings: dict, limits: dict) -> dict:
    return {k: {"value": readings.get(k), "limit": limits[k]} for k in limits}


def passed(ch: dict) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"] for v in ch.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_json("workloads", args.workload)
    cfg_file = load_json("configs", cell["config"])
    tr = load_json("traffic", cell["traffic"])
    cache_env()
    sys.path.insert(0, str(ROOT))
    from benchmark.reference import for_config

    for_config(cfg_file)    # a configuration whose reference is missing ends here
    if not device_ok(int(cell["chips"])):
        return 2
    quiet_host()
    if not (ROOT / "ppyolo_tpu_torch").is_dir():
        print("benchmark: the program under test (ppyolo_tpu_torch/) is not in this checkout",
              file=sys.stderr)
        return 3
    runner = importlib.import_module(f"benchmark.harness.{tr['runner']}")
    out = runner.run(cfg_file, tr, args.seed, args.seconds, bool(args.trace), T_START,
                     chips=int(cell["chips"]))
    return report(out, cell, args, listed(args.workload))


def report(out: dict, cell: dict, args, names: set = None) -> int:
    if loaded_jax():
        return 4
    ch = checks(out["readings"], cell["limits"])
    correct = passed(ch) and out["failed"] == 0
    rec = out["record"]
    if args.trace:
        metrics = {}
        for name, mod in readers().items():
            v = mod.read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in out["e2e"].items()}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    if names is not None:
        metrics = {k: v for k, v in metrics.items() if k in names}
    device = {"platform": "gpu", "kind": out["device_name"],
              "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak"])}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        from benchmark.harness import trace

        device["busy_s"] = rec.get("chips_busy_s", rec["busy_s"])    # over the cards used
        device["window_s"] = rec.get("chips_window_s", rec["window_s"])
        result["breakdown"] = trace.breakdown(rec["dev"], rec["spans"], rec["host"])
    result["checks"] = ch
    print(json.dumps(result))
    sys.stdout.flush()
    for k, v in ch.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
