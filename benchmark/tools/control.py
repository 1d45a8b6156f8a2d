"""Readings of a cell's output check over many seeds in one process, for
setting its limits (PERF.md, "How `correct` is decided").

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --mode program|control [--precision <p>] [--fault <name>]

``program`` runs the cell as ``run.py`` does (the lower readings).
``control`` puts the next precision below the configuration's in the
program's place: for a bf16 serving cell the program's own int8 serving
form; for a bf16 training cell, which the program has no lower path for,
the reference with every conv's operands rounded to fp8
(``reference/train.py``).  ``--precision`` puts another precision in its
place (for training, ``bf16``: the reference rounded as the program's
bf16 step is, the witness of what bf16 rounding does to each reading).
``--fault`` plants a fault: for serving one of ``harness/faults.py``'s,
for training ``half_batch`` or ``ema_unchanged`` (in the reference put in
the program's place) or, on ranks, ``no_exchange`` or
``no_grad_exchange`` (in the program).  One
JSON line per seed; a cell on more than one card runs its ranks anew for
each.  Not run by the benchmark itself.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

# the next precision below the configuration's: the program's own int8
# serving form; for training, which the program has no lower path for, fp8
# in the reference put in the program's place (harness/train.py)
CONTROL_PRECISION = {"serve": {"bf16": "int8"}, "train": {"bf16": "fp8"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--mode", choices=("program", "control"), default="program")
    ap.add_argument("--precision", default=None)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    cell = run.load_json("workloads", args.workload)
    cfg_file = run.load_json("configs", cell["config"])
    tr = run.load_json("traffic", cell["traffic"])
    run.cache_env()
    if not run.device_ok(int(cell["chips"])):
        return 2
    run.quiet_host()
    runner = importlib.import_module(f"benchmark.harness.{tr['runner']}")
    kw = {}
    if args.mode == "control":
        kind = "serve" if tr["runner"] == "serve" else "train"
        kw["precision"] = (args.precision
                           or CONTROL_PRECISION[kind][cfg_file["precision"][kind]])
    if args.fault:
        kw["fault"] = args.fault
    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner.run(cfg_file, tr, seed, args.seconds, False, time.time(),
                         chips=int(cell["chips"]), **kw)
        print(json.dumps({"workload": args.workload, "seed": seed, "mode": args.mode,
                          "precision": kw.get("precision"), "fault": args.fault, "readings": out["readings"],
                          "failed": out["failed"], "attempted": out["attempted"],
                          "e2e": {k: v for k, (v, _) in out["e2e"].items()},
                          "setup_s": out["setup_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
