"""The training runner on two gloo ranks of the CPU: the program's sync-BN
step against the reference's on the same ranks, the faults that leave the
statistics or the gradient exchange out, the ranked reference against one
process's step over the ranks' batches together, and a rank that loaded
JAX ending the run without a result."""
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import ranks, traffic, train
from benchmark.reference import model as ref
from benchmark.reference import train as reftrain

from .test_portbench_harness import TINY, TRAIN_LIMITS, TRAIN_TRAFFIC, report

# The port's CPU sync-BN calls ``torch.distributed.nn.functional.all_reduce``,
# whose default group is bound when that module is first imported.  Imported
# here, before any group exists, it is None, and each test's group is used;
# imported inside a rank, every later test in this process would get the first
# test's group, long destroyed.
import ppyolo_tpu_torch.ops.module  # noqa: F401

SYNC_TRAFFIC = dict(TRAIN_TRAFFIC, norm_type="sync_bn", exposure=[0.25, 1.0])
SEED = 2 ** 33 + 11


@pytest.mark.parametrize("fault", [None, "no_exchange", "no_grad_exchange"])
def test_sync_bn_ranks_are_correct_and_no_exchange_fails(fault):
    out = train.run(TINY, SYNC_TRAFFIC, SEED, 0.3, False, time.time(), chips=2,
                    device="cpu", fault=fault)
    res = report(out, TRAIN_LIMITS)
    assert res["correct"] == (fault is None), res["checks"]
    assert res["attempted"] > 0 and res["metrics"]["train_img_per_s"]["value"] > 0


def _ranked_reference(rank: int, port: int, cfg: dict, P: dict, path: str) -> None:
    store = torch.distributed.TCPStore(ranks.HOST, port, 2, False, timeout=ranks.STORE_TIMEOUT)
    ranks.join(store, 2, rank, "cpu")
    try:
        pool = traffic.train_batches(SYNC_TRAFFIC, cfg, SEED, rank)
        out = reftrain.steps(ref, cfg, P, pool, drop_seed=1, device=torch.device("cpu"),
                             ranks=True)
    finally:
        ranks.leave()
    if rank == 0:
        Path(path).write_text(json.dumps(out))


def test_ranked_reference_is_one_process_over_the_ranks_batches(tmp_path):
    """Sync-BN over two ranks of 2 images each is the one-process step over
    the 4 images (DropBlock, whose draws are each rank's own, left out)."""
    from benchmark.harness import weights

    cfg = train.train_cfg(TINY, SYNC_TRAFFIC)
    cfg["head"]["drop_block"] = False
    P = weights.make_state_dict(ref, cfg, SEED, "cpu", SYNC_TRAFFIC["size"])
    store = torch.distributed.TCPStore(ranks.HOST, 0, 2, True, timeout=ranks.STORE_TIMEOUT,
                                       wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ranked_reference,
                         args=(r, store.port, cfg, P, str(tmp_path / "r0.json")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert p.exitcode == 0
    got = json.loads((tmp_path / "r0.json").read_text())
    pools = [traffic.train_batches(SYNC_TRAFFIC, cfg, SEED, r) for r in range(2)]
    whole = [{k: np.concatenate([a[k], b[k]]) for k in a} for a, b in zip(*pools)]
    want = reftrain.steps(ref, cfg, P, whole, drop_seed=1, device=torch.device("cpu"))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for name in ("grad", "step", "ema", "bn"):
        keys = [k for k in want[name] if want[name][k] > 1e-6]
        assert keys
        np.testing.assert_allclose([got[name][k] for k in keys],
                                   [want[name][k] for k in keys], rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("load_jax", [False, True])
def test_a_rank_that_loaded_jax_gives_no_result(load_jax):
    """Rank 1 holding a module named ``jax`` after its run ends the run with
    an error and no result, as rank 0 holding one does in ``run.report``."""
    code = ("import json; from benchmark.harness import ranks; "
            "out = ranks.lead(2, 'cpu', 'benchmark.tests.rank_stub', "
            f"dict(load_jax={load_jax})); print('RESULT', json.dumps(out))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ranks.ROOT, capture_output=True,
                       text=True, timeout=300)
    if load_jax:
        assert p.returncode != 0 and "RESULT" not in p.stdout, p.stdout
        assert "rank 1 loaded ['jax']" in p.stderr, p.stderr[-2000:]
    else:
        assert p.returncode == 0, p.stderr[-2000:]
        assert 'RESULT {"world": 2}' in p.stdout
