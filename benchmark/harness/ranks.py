"""A cell on more than one card: one process a card, in one
``torch.distributed`` group.

The process ``run.py`` started is rank 0: ``lead`` opens the group's
store on a free local port, starts ranks 1.. as ``python3 -m
benchmark.harness.ranks <spec>``, joins the group (NCCL on cuda:<rank>,
gloo on the CPU for the harness's own tests) and runs the runner module's
``run_rank`` as rank 0, whose result is the run's.  Every other rank runs
the same ``run_rank`` on its own card and prints nothing to stdout.

A rank that fails ends the run: rank 0 watches the others and, when one
exits with an error, stops the rest and exits with an error itself; a
rank whose rank 0 is gone exits.  A rank whose process holds JAX or the
JAX package once its run is over exits with an error, as ``run.py`` does
for rank 0.  Rank 0 returns only after every rank has left the group and
ended.

``MARKS`` holds the wall-clock times at which this process passed the
steps of its set-up (``mark``), for the runner to print.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HOST = "127.0.0.1"
# a collective outwaits the first run's kernel builds, which one rank
# makes while the others wait for it
GROUP_TIMEOUT = datetime.timedelta(seconds=900)
STORE_TIMEOUT = datetime.timedelta(seconds=300)
END_WAIT_S = 120.0
MARKS: list = []


def mark(name: str) -> None:
    MARKS.append((name, time.time()))


def join(store, world: int, rank: int, device_type: str):
    """Join the group through ``store``; returns this rank's device."""
    import torch
    import torch.distributed as tdist

    os.environ["LOCAL_RANK"] = str(rank)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        tdist.init_process_group("nccl", store=store, rank=rank, world_size=world,
                                 timeout=GROUP_TIMEOUT, device_id=device)
    else:
        device = torch.device("cpu")
        tdist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                 timeout=GROUP_TIMEOUT)
    return device


def leave() -> None:
    import gc

    import torch.distributed as tdist

    gc.collect()    # a live graph that captured collectives keeps the group busy
    tdist.destroy_process_group()


def _watch(procs, done: threading.Event) -> None:
    """Rank 0's watch: a rank that exits with an error ends the run."""
    while not done.wait(0.5):
        for r, p in enumerate(procs, start=1):
            code = p.poll()
            if code and not done.is_set():
                print(f"benchmark: rank {r} exited with code {code}", file=sys.stderr,
                      flush=True)
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(5)


def lead(world: int, device_type: str, runner: str, spec: dict) -> dict:
    """Run the module ``runner``'s ``run_rank(**spec, device=...)`` on
    ``world`` ranks, this process rank 0; returns rank 0's result."""
    import importlib

    import torch.distributed as tdist

    store = tdist.TCPStore(HOST, 0, world, True, timeout=STORE_TIMEOUT,
                           wait_for_workers=False)
    base = dict(runner=runner, world=world, port=store.port, device_type=device_type,
                spec=spec)
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.harness.ranks",
                               json.dumps(dict(base, rank=r))],
                              cwd=ROOT, stdin=subprocess.DEVNULL, stdout=2)
             for r in range(1, world)]
    mark("spawned")
    done = threading.Event()
    try:
        threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
        device = join(store, world, 0, device_type)
        mark("joined")
        try:
            out = importlib.import_module(runner).run_rank(**spec, device=device)
        finally:
            leave()
        for r, p in enumerate(procs, start=1):
            if p.wait(timeout=END_WAIT_S):
                raise RuntimeError(f"rank {r} exited with code {p.returncode}")
        return out
    finally:
        done.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _orphaned(parent: int) -> None:
    """A rank whose rank 0 is gone exits."""
    while True:
        if os.getppid() != parent:
            os._exit(6)
        time.sleep(1.0)


def main(argv) -> int:
    import importlib

    mark("up")
    a = json.loads(argv[0])
    threading.Thread(target=_orphaned, args=(os.getppid(),), daemon=True).start()
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    import torch.distributed as tdist

    run.quiet_host()
    store = tdist.TCPStore(HOST, a["port"], a["world"], False, timeout=STORE_TIMEOUT)
    device = join(store, a["world"], a["rank"], a["device_type"])
    mark("joined")
    try:
        importlib.import_module(a["runner"]).run_rank(**a["spec"], device=device)
    finally:
        leave()
    return 4 if run.loaded_jax(f"rank {a['rank']}") else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
