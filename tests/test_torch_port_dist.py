"""The port's data parallelism on the CPU: two gloo ranks against the JAX
package and against the port's own one-process step.

One 2-rank job runs per module (two spawned processes, one thread each,
``init_method=file://`` under the test's temporary directory, every wait
bounded by a timeout that kills both ranks) and writes its results to npz;
each test function asserts on one of them.  Held, on the mini-2x
configuration (``test_torch_port_train.mini2x_cfg``) at 64 px, 2 images a
rank:

1. a ``sync_bn`` ConvNormAct on 2 ranks against JAX ``batch_norm`` under
   ``shard_map`` on 2 devices: y, the running statistics and the input and
   parameter gradients of each rank, at fp32 rtol 1e-5 (atol 1e-6 where
   values cross zero);
2. a ``sync_bn`` train step on 2 ranks against the port's one-process step
   over the 4 images in fp64: every velocity, parameter move, EMA move and
   running-statistic leaf within relative L2 1e-11 (measured 1.8e-13: the
   two sum the batch statistics and the gradients in another order), the
   loss terms within 1e-6 relative (the loss reads the head maps in
   float32, as the JAX package's does; measured 9.3e-8);
3. the same step in fp32 against JAX ``shard_train_step(make_train_step(...,
   axis_name="data"), make_mesh(2))`` at the tolerances of
   ``test_torch_port_train.py::test_train_step_matches_jax``;
4. ``norm="bn"``: rank 0's losses, running statistics (its own half batch)
   and the output convs' velocity against JAX's replicated output read from
   device 0, the running statistics different on the two ranks, and the
   parameters, velocity and EMA bitwise equal on both ranks;
5. ``make_multi_train_step(n_steps=2)`` (DropBlock on, one seed on every
   rank) bitwise equal to two sequential 2-rank steps;
6. the backbone remat step against the plain one at JAX's rtol 1e-5
   (``tests/test_train.py::test_remat_step_matches_plain``), the running
   statistics bitwise (one momentum update);
7. ``Detector.predict_sharded`` (``make_sharded_predict``): bitwise each
   rank's ``predict_batch`` of its slice gathered in rank order, and one
   ``predict_batch`` of the whole batch with the same labels and scores and
   boxes within 1e-3 relative (the CPU convs round a batch of 2 and one of 4
   differently: measured 1.8e-4); ``broadcast_state`` makes two
   differently initialised replicas equal.
"""
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.ops.conv import batch_norm as jax_batch_norm
from ppyolo_tpu.ops.module import flatten_tree as jax_flatten
from ppyolo_tpu.ops.module import unflatten_tree as jax_unflatten
from ppyolo_tpu.parallel.mesh import make_mesh, put_batch, put_replicated, shard_train_step
from ppyolo_tpu.train import init_train_state as jax_init_state
from ppyolo_tpu.train import make_train_step as jax_make_step

from ppyolo_tpu_torch.checkpoint.bridge import hwio_to_oihw, state_dict_to_jax_params
from ppyolo_tpu_torch.models import PPYOLO

from test_torch_port_train import mini2x_cfg, rel_l2, synthetic_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PER_RANK = 2
RANK_TIMEOUT_S = 300


def run_ranks(worker_src: str, tmp, *args, world: int = WORLD,
              timeout: float = RANK_TIMEOUT_S):
    """Start ``world`` ranks of ``worker_src`` (argv: rank, world, the
    file:// init address, then ``args``) and return their Popen handles."""
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(worker_src)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    init = "file://" + os.path.join(tmp, "pg_init")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world), init,
                               *map(str, args)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(world)]
    for log in logs:
        log.close()
    return procs, time.time() + timeout


def wait_ranks(handle, tmp):
    """Wait for every rank (killing all of them when the deadline passes or
    one fails) and raise with their logs unless all exited 0."""
    procs, deadline = handle
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait(timeout=30)
    if hung or any(p.returncode for p in procs):
        logs = "\n".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-4000:]
                         for r in range(len(procs)))
        raise AssertionError(f"ranks {'timed out' if hung else 'failed'}: "
                             f"{[p.returncode for p in procs]}\n{logs}")


def load_ranks(tmp, world: int = WORLD):
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


_WORKER = r'''
import os, pickle, sys
rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from ppyolo_tpu_torch.eval.detector import Detector
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.ops.conv import ConvNormAct
from ppyolo_tpu_torch.parallel import dist
from ppyolo_tpu_torch.train.train_step import (init_train_state, make_multi_train_step,
                                               make_train_step)

cfgs = pickle.load(open(os.path.join(tmp, "cfgs.pkl"), "rb"))
with np.load(os.path.join(tmp, "inputs.npz")) as f:
    inp = {k: f[k] for k in f.files}
sd0 = {k[3:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("sd/")}
out = {}
PER = inp["batch/image"].shape[0] // world


def batch(prefix, lo, hi):
    return {k[len(prefix):]: torch.from_numpy(v[lo:hi]) for k, v in inp.items()
            if k.startswith(prefix)}


def mine(prefix):
    return batch(prefix, rank * PER, (rank + 1) * PER)


def model(cfg, dtype=torch.float32):
    """The bridged JAX params, or (DropBlock's layers shift the paths) a
    seeded init, the same on every rank."""
    m = PPYOLO.from_config(cfg)
    if cfg.head["drop_block"]:
        m.init_parameters(torch.Generator().manual_seed(0))
    else:
        m.load_state_dict(sd0)
    return m.to(dtype=dtype, memory_format=torch.channels_last)


def arrays(state, with_ema=True):
    d = {f"param/{k}": v for k, v in state.model.state_dict().items()}
    d.update({f"vel/{k}": v for k, v in state.velocity().items()})
    if with_ema:
        d.update({f"ema/{k}": v for k, v in state.ema.items()})
    return {k: v.detach().numpy() for k, v in d.items()}


def same_on_all_ranks(tensors):
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    ref = flat.clone()
    tdist.broadcast(ref, 0)
    ok = torch.tensor([float(torch.equal(ref, flat))])
    tdist.all_reduce(ok, op=tdist.ReduceOp.MIN)
    return bool(ok.item())


def step_once(cfg, dtype, b, generator=None, **kw):
    m = model(cfg, dtype)
    state = init_train_state(m, cfg)
    state, losses = make_train_step(m, cfg, compute_dtype=dtype, **kw)(state, b, generator)
    return state, {k: float(v) for k, v in losses.items()}


# 2. the one-process fp64 step over every image, before the group exists
if rank == 0:
    ref_state, ref_losses = step_once(cfgs["sync"], torch.float64, batch("batch/", 0, None))
    ref64 = arrays(ref_state)
    del ref_state

dev = dist.init_from_env("cpu", init_method=init)
assert dev == torch.device("cpu") and dist.backend() == "gloo" and dist.world() == world

# 1. a sync_bn ConvNormAct
cna = ConvNormAct(8, 16, 3, norm="sync_bn", act="leaky").train()
with torch.no_grad():
    cna.conv.weight.copy_(torch.from_numpy(inp["cna/w"]))
    cna.bn.weight.copy_(torch.from_numpy(inp["cna/scale"]))
    cna.bn.bias.copy_(torch.from_numpy(inp["cna/bias"]))
lo, hi = rank * PER, (rank + 1) * PER
x = torch.from_numpy(inp["cna/x"][lo:hi]).requires_grad_()
y = cna(x)
(y * torch.from_numpy(inp["cna/cot"][lo:hi])).sum().backward()
out.update({"cna/y": y.detach().numpy(), "cna/x_grad": x.grad.numpy(),
            "cna/w_grad": cna.conv.weight.grad.numpy(),
            "cna/scale_grad": cna.bn.weight.grad.numpy(),
            "cna/bias_grad": cna.bn.bias.grad.numpy(),
            "cna/mean": cna.bn.running_mean.numpy(), "cna/var": cna.bn.running_var.numpy()})

# 3. the sync_bn step in fp32
state, losses = step_once(cfgs["sync"], torch.float32, mine("batch/"))
out["sync/replicas_equal"] = same_on_all_ranks(state.tensors().values())
if rank == 0:
    out.update({f"sync/{k}": v for k, v in arrays(state).items()})
    out.update({f"sync/loss/{k}": v for k, v in losses.items()})
del state

# 2. the same step in fp64, held against the one-process step here
state, losses = step_once(cfgs["sync"], torch.float64, mine("batch/"))
if rank == 0:
    got = arrays(state)
    out["fp64/loss_rel"] = max(abs(losses[k] - ref_losses[k]) / max(abs(ref_losses[k]), 1e-30)
                               for k in ref_losses)
    p0 = {k: v.double().numpy() for k, v in sd0.items()}
    rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)
    worst = {"vel": 0.0, "param": 0.0, "ema": 0.0, "running": 0.0}
    for k, want in ref64.items():
        group, _, leaf = k.partition("/")
        if leaf.endswith(("running_mean", "running_var")):
            group, err = "running", rel(got[k], want)
        elif group == "vel":
            err = rel(got[k], want)
        else:   # params and EMA: the move from the start
            err = rel(got[k] - p0[leaf], want - p0[leaf]) if np.any(want != p0[leaf]) else (
                0.0 if np.array_equal(got[k], want) else np.inf)
        worst[group] = max(worst[group], err)
    out.update({f"fp64/{g}_rel_l2": v for g, v in worst.items()})
del state

# 4. norm="bn": each rank's own statistics
state, losses = step_once(cfgs["bn"], torch.float32, mine("batch/"))
out["bn/replicas_equal"] = same_on_all_ranks(
    [v for k, v in state.tensors().items() if "running_" not in k])
out["bn/running_differ"] = not same_on_all_ranks(
    [v for k, v in state.tensors().items() if "running_" in k])
if rank == 0:
    a = arrays(state, with_ema=False)
    out.update({f"bn/{k}": v for k, v in a.items()
                if k.startswith("vel/head.yolo_output_convs") or "running_" in k})
    out.update({f"bn/loss/{k}": v for k, v in losses.items()})
del state

# 5. a 2-step unit against two steps, DropBlock on
cfg = cfgs["dropblock"]
seqs = []
for kind in ("steps", "unit"):
    m = model(cfg)
    state = init_train_state(m, cfg)
    gen = torch.Generator().manual_seed(5)
    b1, b2 = mine("batch/"), mine("batch2/")
    if kind == "steps":
        step = make_train_step(m, cfg)
        state, _ = step(state, b1, gen)
        state, _ = step(state, b2, gen)
    else:
        multi = make_multi_train_step(m, cfg, n_steps=2)
        state, _ = multi(state, {k: torch.stack([b1[k], b2[k]]) for k in b1}, gen)
    seqs.append({k: v.clone() for k, v in state.tensors().items()})
    out[f"multi/{kind}_replicas_equal"] = same_on_all_ranks(state.tensors().values())
out["multi/bitwise"] = all(torch.equal(seqs[0][k], seqs[1][k]) for k in seqs[0])
del seqs, state

# 6. remat against the plain step
runs = [step_once(cfgs["sync"], torch.float32, mine("batch/"), remat=r) for r in (False, True)]
(sp, lp), (sr, lr) = runs
tp, tr = sp.tensors(), sr.tensors()
out["remat/loss_plain"] = lp["total_loss"]
out["remat/loss_remat"] = lr["total_loss"]
out["remat/params_close"] = all(
    torch.allclose(tr[k], tp[k], rtol=1e-5, atol=1e-6) for k in tp if not k.endswith("step"))
out["remat/running_bitwise"] = all(torch.equal(tr[k], tp[k]) for k in tp if "running_" in k)
out["remat/running_moved"] = all(not torch.equal(tp[k], sd0[k[6:]]) for k in tp
                                 if k.endswith("running_mean"))
del runs, sp, sr, tp, tr

# 7. the sharded predict, and the state broadcast
det = Detector(PPYOLO.from_config(cfgs["sync"]), sd0, cfgs["sync"], target_size=64,
               device="cpu")
ims, sizes = inp["predict/image"], inp["predict/im_size"]
out["predict/sharded"] = det.predict_sharded(ims, sizes)
out["predict/whole"] = det.predict_batch(ims, sizes)
out["predict/mine"] = det.predict_batch(ims[rank * PER:(rank + 1) * PER],
                                        sizes[rank * PER:(rank + 1) * PER])
m = PPYOLO.from_config(cfgs["sync"]).init_parameters(torch.Generator().manual_seed(rank))
state = init_train_state(m, cfgs["sync"])
state.set_step(7 * rank)
out["broadcast/equal_before"] = same_on_all_ranks(state.tensors().values())
dist.broadcast_state(state)
out["broadcast/equal_after"] = same_on_all_ranks(state.tensors().values())
out["broadcast/step"] = state.step

np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
tdist.destroy_process_group()
'''


def _cfg(norm, drop_block=False):
    cfg = mini2x_cfg()
    cfg.backbone = dict(cfg.backbone, norm_type=norm)
    cfg.head = dict(cfg.head, norm_type=norm, drop_block=drop_block)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs (seeded mini-2x params with perturbed offset convs, as JAX
    params through the bridge, batches, the ConvNormAct case) and the configurations, written
    for the ranks, which start here."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    cfgs = {"sync": _cfg("sync_bn"), "bn": _cfg("bn"), "dropblock": _cfg("sync_bn", True)}
    with open(os.path.join(tmp, "cfgs.pkl"), "wb") as f:
        pickle.dump(cfgs, f)
    model = PPYOLO.from_config(cfgs["sync"]).init_parameters(torch.Generator().manual_seed(0))
    r = np.random.RandomState(7)
    with torch.no_grad():   # offsets that make every DCN interpolate
        for k, v in sorted(model.state_dict().items()):
            if k.endswith(("conv_offset.weight", "conv_offset.bias")):
                v.copy_(torch.from_numpy((r.randn(*v.shape) * 0.02).astype(np.float32)))
    sd = model.state_dict()
    flat = state_dict_to_jax_params(sd)
    n = WORLD * PER_RANK
    b1, b2 = synthetic_batch(0, n, 64, 2), synthetic_batch(1, n, 64, 2)
    r = np.random.RandomState(3)
    cna = {"x": r.randn(n, 8, 12, 12).astype(np.float32),
           "w": (r.randn(16, 8, 3, 3) * 0.2).astype(np.float32),
           "scale": r.uniform(0.5, 1.5, 16).astype(np.float32),
           "bias": r.randn(16).astype(np.float32) * 0.1,
           "cot": r.randn(n, 16, 12, 12).astype(np.float32)}
    pred = {"image": r.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8),
            "im_size": np.tile(np.array([[96.0, 128.0]], np.float32), (n, 1))}
    inputs = {**{f"sd/{k}": v.numpy() for k, v in sd.items()},
              **{f"batch/{k}": v for k, v in b1.items()},
              **{f"batch2/{k}": v for k, v in b2.items()},
              **{f"cna/{k}": v for k, v in cna.items()},
              **{f"predict/{k}": v for k, v in pred.items()}}
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    handle = run_ranks(_WORKER, tmp, tmp)
    return dict(tmp=tmp, handle=handle, cfgs=cfgs, flat=flat, batch=b1, cna=cna, sd=sd)


def _jax_step(cfg, flat, batch):
    """One JAX ``shard_train_step`` on a 2-device mesh; the outputs as
    numpy, read as device 0's (the replicated ``out_specs``)."""
    jm = JaxPPYOLO.from_config(cfg)
    mesh = make_mesh(WORLD)
    state = put_replicated(
        jax_init_state(jm, jax_unflatten({k: jnp.asarray(v) for k, v in flat.items()}), cfg),
        mesh)
    step = shard_train_step(jax_make_step(jm, cfg, axis_name="data"), mesh)
    state, losses = step(state, put_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
                         jax.random.PRNGKey(0))
    to_np = lambda t: {k: np.asarray(v) for k, v in t.items()}
    return dict(losses={k: float(v) for k, v in losses.items()},
                params=to_np(jax_flatten(state.params)), velocity=to_np(state.velocity),
                ema=to_np(state.ema))


def _jax_cna(c):
    """The ConvNormAct case under ``shard_map``: each device's y, running
    statistics and gradients, stacked by device."""
    def local(x, w, scale, bias, cot):
        def loss(x, w, scale, bias):
            h = lax.conv_general_dilated(x, w, (1, 1), [(1, 1), (1, 1)],
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
            y, nm, nv = jax_batch_norm(h, scale, bias, jnp.zeros(16), jnp.ones(16),
                                       train=True, axis_name="data")
            y = jnp.where(y >= 0, y, 0.1 * y)
            return jnp.sum(y * cot), (y, nm, nv)

        (_, (y, nm, nv)), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                 has_aux=True)(x, w, scale, bias)
        return y, nm[None], nv[None], g[0], g[1][None], g[2][None], g[3][None]

    mesh = make_mesh(WORLD)
    d = P("data")
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(d, P(), P(), P(), d),
                               out_specs=(d,) * 7, check_vma=False))
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    outs = fn(nhwc(c["x"]), jnp.asarray(c["w"].transpose(2, 3, 1, 0)), jnp.asarray(c["scale"]),
              jnp.asarray(c["bias"]), nhwc(c["cot"]))
    return [np.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The JAX references, computed while the ranks run."""
    s = setup
    return {"cna": _jax_cna(s["cna"]), "sync": _jax_step(s["cfgs"]["sync"], s["flat"], s["batch"]),
            "bn": _jax_step(s["cfgs"]["bn"], s["flat"], s["batch"])}


@pytest.fixture(scope="module")
def ranks(setup, jax_refs):
    wait_ranks(setup["handle"], setup["tmp"])
    return load_ranks(setup["tmp"])


def _oihw(k, v):
    return hwio_to_oihw(v) if v.ndim == 4 else v


def test_sync_bn_conv_matches_jax_shard_map(ranks, jax_refs):
    y, nm, nv, gx, gw, gs, gb = jax_refs["cna"]
    for r, got in enumerate(ranks):
        sl = slice(r * PER_RANK, (r + 1) * PER_RANK)
        np.testing.assert_allclose(got["cna/y"].transpose(0, 2, 3, 1), y[sl], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["cna/x_grad"].transpose(0, 2, 3, 1), gx[sl], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["cna/mean"], nm[r], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["cna/var"], nv[r], rtol=1e-5)
        np.testing.assert_allclose(got["cna/w_grad"], hwio_to_oihw(gw[r]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["cna/scale_grad"], gs[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["cna/bias_grad"], gb[r], rtol=1e-5, atol=1e-5)


def test_two_rank_fp64_step_matches_one_process_full_batch(ranks):
    got = ranks[0]
    assert float(got["fp64/loss_rel"]) <= 1e-6
    for key in ("fp64/vel_rel_l2", "fp64/ema_rel_l2", "fp64/param_rel_l2",
                "fp64/running_rel_l2"):
        assert float(got[key]) <= 1e-11, (key, float(got[key]))


def test_two_rank_sync_bn_step_matches_jax_shard_train_step(ranks, jax_refs, setup):
    want, got, sd = jax_refs["sync"], ranks[0], setup["sd"]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got[f"sync/loss/{k}"]), v, rtol=1e-3, err_msg=k)
    for k, jv in want["velocity"].items():
        tol = 2e-3 if k.startswith("head.yolo_output_convs") else 0.2
        p0 = sd[k].numpy()
        assert rel_l2(got[f"sync/vel/{k}"], _oihw(k, jv)) <= tol, k
        assert rel_l2(got[f"sync/param/{k}"] - p0, _oihw(k, want["params"][k]) - p0) <= tol, k
        assert rel_l2(got[f"sync/ema/{k}"] - p0, _oihw(k, want["ema"][k]) - p0) <= tol, k
    for k, v in want["params"].items():
        if k.endswith(("running_mean", "running_var")):
            assert rel_l2(got[f"sync/param/{k}"], v) <= 1e-3, k
    assert all(bool(r["sync/replicas_equal"]) for r in ranks)


def test_bn_keeps_each_rank_statistics_as_jax_device_0(ranks, jax_refs):
    want, got = jax_refs["bn"], ranks[0]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got[f"bn/loss/{k}"]), v, rtol=1e-3, err_msg=k)
    for k, v in want["params"].items():
        if k.endswith(("running_mean", "running_var")):
            assert rel_l2(got[f"bn/param/{k}"], v) <= 1e-3, k
    for k, jv in want["velocity"].items():
        if k.startswith("head.yolo_output_convs"):
            assert rel_l2(got[f"bn/vel/{k}"], _oihw(k, jv)) <= 2e-3, k
    assert all(bool(r["bn/replicas_equal"]) for r in ranks)
    assert all(bool(r["bn/running_differ"]) for r in ranks)


def test_multi_step_unit_is_bitwise_two_sharded_steps(ranks):
    for r in ranks:
        assert bool(r["multi/bitwise"])
        assert bool(r["multi/steps_replicas_equal"]) and bool(r["multi/unit_replicas_equal"])


def test_remat_step_matches_plain_with_one_stat_update(ranks):
    for r in ranks:
        np.testing.assert_allclose(float(r["remat/loss_remat"]), float(r["remat/loss_plain"]),
                                   rtol=1e-5)
        assert bool(r["remat/params_close"])
        assert bool(r["remat/running_bitwise"]) and bool(r["remat/running_moved"])


def test_sharded_predict_equals_predict_batch(ranks):
    gathered = np.concatenate([r["predict/mine"] for r in ranks])
    whole = ranks[0]["predict/whole"]
    for r in ranks:
        np.testing.assert_array_equal(r["predict/sharded"], gathered)
    np.testing.assert_array_equal(gathered[..., 0], whole[..., 0])
    np.testing.assert_allclose(gathered[..., 1:], whole[..., 1:], rtol=1e-3, atol=1e-3)


def test_broadcast_state_makes_replicas_equal(ranks):
    for r in ranks:
        assert not bool(r["broadcast/equal_before"])
        assert bool(r["broadcast/equal_after"]) and int(r["broadcast/step"]) == 0
