"""The port's multi-step dispatch on the CPU, against the JAX package.

The units of work that run as CUDA graphs on the card run eagerly here,
and are held:

* the device LR and EMA decay (read from the step counter on the device)
  bitwise against the host ``make_lr_fn`` and ``ema_decay_at`` at every
  step up to past the last milestone;
* the foreach SGD bitwise against ``torch.optim.SGD``, and against the JAX
  package's ``sgd_momentum_update``;
* ``make_multi_train_step`` in each target pipeline bitwise against the
  same number of calls of ``make_train_step``, and against the JAX
  package's ``make_multi_train_step`` (fp32) at the tolerances of
  ``test_torch_port_train.py::test_train_step_matches_jax``;
* a unit's ``prepare`` (``warmup_shapes``) leaves the state, the generator
  and the step untouched, and the trajectory equal to a run without it;
* the training entry with ``scan_steps=2`` (and ``warmup_shapes``): its
  metrics rows, checkpoints, and 2+2 steps with a resume equal to 4;
* ``Graphs`` recomputing the parameter-derived caches into their tensors
  before a replay when, and only when, a parameter was written;
* ``Detector.predict_pipelined`` bitwise against ``predict_batch`` and
  against the JAX package's ``predict_pipelined``; ``run_eval`` with
  ``scan_group`` 2 and 3 equal to ``scan_group=1``.

The mini-2x configuration (``test_torch_port_train.mini2x_cfg``) at 64 px.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from configs import PPYOLO_2x_Config
from ppyolo_tpu.eval.detector import Detector as JaxDetector
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.ops.module import ParamPolicy as JaxParamPolicy
from ppyolo_tpu.ops.module import flatten_tree as jax_flatten
from ppyolo_tpu.ops.module import unflatten_tree as jax_unflatten
from ppyolo_tpu.train import init_train_state as jax_init_state
from ppyolo_tpu.train.optimizer import sgd_momentum_update
from ppyolo_tpu.train.train_step import make_multi_train_step as jax_make_multi

from ppyolo_tpu_torch.checkpoint.bridge import hwio_to_oihw, jax_params_to_state_dict
from ppyolo_tpu_torch.entry import eval as eval_entry
from ppyolo_tpu_torch.entry import train as train_entry
from ppyolo_tpu_torch.eval.detector import Detector
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.ops.ema import ema_decay_at, ema_decay_device, ema_update
from ppyolo_tpu_torch.ops.module import ParamPolicy
from ppyolo_tpu_torch.tools.warmup_shapes import dummy_batch, warmup_units
from ppyolo_tpu_torch.train.graphs import GraphedStep, Graphs
from ppyolo_tpu_torch.train.loop import make_unit_step, will_log
from ppyolo_tpu_torch.train.lr_schedule import DeviceLR, make_lr_fn
from ppyolo_tpu_torch.train.optimizer import SGD
from ppyolo_tpu_torch.train.train_step import (init_train_state, make_multi_train_step,
                                               make_train_step)

from test_torch_port_entry import _equal_states, dataset, entry_cfg  # noqa: F401
from test_torch_port_model import assert_pred_close
from test_torch_port_train import mini2x_cfg, rel_l2, synthetic_batch, to_torch

N_STEPS = 3


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------- LR and EMA decay

LR_CONFIGS = {
    "ppyolo_2x": PPYOLO_2x_Config().learningRate,
    # a milestone inside the warmup, a start factor of 0
    "early_milestone": dict(base_lr=0.01, PiecewiseDecay=dict(gamma=0.1, milestones=[5, 9]),
                            LinearWarmup=dict(start_factor=0.0, steps=7)),
}


@pytest.mark.parametrize("name", sorted(LR_CONFIGS))
def test_device_lr_is_bitwise_the_host_lr(name):
    cfg = LR_CONFIGS[name]
    last = max([cfg["LinearWarmup"]["steps"], *cfg["PiecewiseDecay"]["milestones"]]) + 100
    steps = np.arange(last + 1)
    lr_fn = make_lr_fn(cfg)
    want = np.array([lr_fn(int(t)) for t in steps], np.float32)
    got = DeviceLR(cfg, "cpu")(torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    one = DeviceLR(cfg, "cpu")(torch.tensor(cfg["LinearWarmup"]["steps"]))
    assert one.shape == () and one.dtype == torch.float32


def test_device_ema_decay_is_bitwise_the_host_decay():
    last = max(PPYOLO_2x_Config().learningRate["PiecewiseDecay"]["milestones"]) + 100
    steps = np.arange(last + 1)
    want = np.array([ema_decay_at(int(t), 0.9998) for t in steps], np.float32)
    got = ema_decay_device(torch.from_numpy(steps), 0.9998).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the update from the device step equals the one from the host step
    r = np.random.RandomState(1)
    p = {k: torch.from_numpy(r.randn(5, 4).astype(np.float32)) for k in "ab"}
    host = {k: v * 0.5 for k, v in p.items()}
    dev = {k: v * 0.5 for k, v in p.items()}
    for t in range(4):
        ema_update(host, p, t, 0.9998)
        ema_update(dev, p, torch.tensor(t), 0.9998)
    assert all(torch.equal(host[k], dev[k]) for k in p)


# ---------------------------------------------------------------- SGD

SHAPES = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 2), "b.bn.weight": (5,),
          "c.weight": (3, 3)}
POLICIES = {"a.weight": (1.0, 1.0, True), "a.bias": (2.0, 0.0, True),
            "b.weight": (1.0, 1.0, False), "b.bn.weight": (0.5, 0.0, True),
            "c.weight": (1.0, 1.0, True)}
SGD_LR = dict(base_lr=0.1, PiecewiseDecay=dict(gamma=0.1, milestones=[2]),
              LinearWarmup=dict(start_factor=0.2, steps=1))


def _sgd_inputs():
    r = np.random.RandomState(4)
    p0 = {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(3)]
    return p0, grads


def test_foreach_sgd_is_bitwise_torch_optim_sgd():
    p0, grads = _sgd_inputs()
    lr_fn = make_lr_fn(SGD_LR)
    mine = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    ref = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = SGD(mine, {k: ParamPolicy(*v) for k, v in POLICIES.items()},
              momentum=0.9, l2_factor=0.0005)
    groups = {}
    for k, (lr_mult, wd_mult, trainable) in POLICIES.items():
        if trainable:
            groups.setdefault((lr_mult, wd_mult), []).append(ref[k])
    torch_sgd = torch.optim.SGD([{"params": ps, "lr_mult": m, "weight_decay": w * 0.0005}
                                 for (m, w), ps in groups.items()], lr=0.0, momentum=0.9)
    step_t = torch.zeros((), dtype=torch.int64)
    device_lr = DeviceLR(SGD_LR, "cpu")
    for t, g in enumerate(grads):
        opt.step({k: torch.from_numpy(g[k]) for k in opt.params}, device_lr(step_t))
        step_t += 1
        for k, p in ref.items():
            p.grad = torch.from_numpy(g[k])
        for group in torch_sgd.param_groups:
            group["lr"] = lr_fn(t) * group["lr_mult"]
        torch_sgd.step()
    for k in SHAPES:
        assert torch.equal(mine[k], ref[k]), k
        if POLICIES[k][2]:
            assert torch.equal(opt.bufs[k], torch_sgd.state[ref[k]]["momentum_buffer"]), k
    assert torch.equal(mine["b.weight"], torch.from_numpy(p0["b.weight"]))


def test_foreach_sgd_matches_jax_sgd_momentum_update():
    p0, grads = _sgd_inputs()
    lr_fn = make_lr_fn(SGD_LR)
    jpol = {k: JaxParamPolicy(*v) for k, v in POLICIES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jvel = {k: jnp.zeros_like(v) for k, v in jp.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = SGD(params, {k: ParamPolicy(*v) for k, v in POLICIES.items()},
              momentum=0.9, l2_factor=0.0005)
    device_lr = DeviceLR(SGD_LR, "cpu")
    for t, g in enumerate(grads):
        jp, jvel = sgd_momentum_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jvel,
                                       jpol, np.float32(lr_fn(t)), momentum=0.9,
                                       l2_factor=0.0005)
        opt.step({k: torch.from_numpy(g[k]) for k in opt.params}, device_lr(torch.tensor(t)))
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        if POLICIES[k][2]:
            np.testing.assert_allclose(opt.bufs[k].numpy(), np.asarray(jvel[k]),
                                       rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- multi-step

def _dropblock_cfg():
    cfg = mini2x_cfg()
    cfg.head = dict(cfg.head, drop_block=True)
    return cfg


def _model(cfg, seed=0):
    return PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(seed))


def _stack(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}


def _state_copy(state):
    return {k: v.clone() for k, v in state.tensors().items()}


@pytest.fixture(scope="module")
def single_step_run():
    """N_STEPS calls of make_train_step (DropBlock on) from seed 0: the
    reference of the multi-step tests."""
    cfg = _dropblock_cfg()
    batches = [synthetic_batch(10 + i, 2, 64, 2) for i in range(N_STEPS)]
    model = _model(cfg)
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for b in batches:
        state, l = step(state, to_torch(b), gen)
        losses.append(l)
    stacked = {k: torch.stack([l[k] for l in losses]) for k in losses[0]}
    return cfg, batches, _state_copy(state), stacked, gen.get_state()


@pytest.mark.parametrize("pipeline", ["step", "prescan", "doublebuf"])
def test_multi_train_step_is_bitwise_n_single_steps(single_step_run, pipeline):
    cfg, batches, want_state, want_losses, want_gen = single_step_run
    model = _model(cfg)
    state = init_train_state(model, cfg)
    multi = make_multi_train_step(model, cfg, n_steps=N_STEPS, target_pipeline=pipeline)
    gen = torch.Generator().manual_seed(5)
    state, losses = multi(state, _stack(batches), gen)
    assert state.step == N_STEPS and int(state.step_t) == N_STEPS
    assert set(losses) == set(want_losses)
    for k, v in losses.items():
        assert v.shape == (N_STEPS,) and torch.equal(v, want_losses[k]), k
    got = state.tensors()
    assert set(got) == set(want_state)
    for k, v in want_state.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(gen.get_state(), want_gen)


def test_multi_train_step_matches_jax():
    """Two fp32 steps as one unit against the JAX package's jitted
    ``make_multi_train_step`` from the same params: the losses of both steps
    within 1e-3, the moves of params, momentum and EMA at the tolerances of
    ``test_train_step_matches_jax`` (2e-3 for the output convs, 0.2 for the
    chaotic rest), BN statistics within 1e-3.  At random init the loss is
    chaotic in the params: a 1e-6 relative change of one stem weight moves
    the losses after one step at the mini-2x LR by up to 13%, and even a
    1e-5 LR moves the next batch's losses by several percent.  So the warmup
    here starts at 0: the first step leaves the params where they were (its
    gradient goes into the momentum, the EMA and the BN statistics still
    move), and the second step's losses are taken at the same params on
    both sides before its update, which carries the first step's momentum."""
    cfg = mini2x_cfg()
    cfg.learningRate = dict(cfg.learningRate,
                            LinearWarmup=dict(cfg.learningRate["LinearWarmup"], start_factor=0.0))
    jm = JaxPPYOLO.from_config(cfg)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jm.init(jax.random.PRNGKey(0))).items()}
    r = np.random.RandomState(7)
    for k in sorted(flat):
        if k.endswith("conv_offset.weight") or k.endswith("conv_offset.bias"):
            flat[k] = (r.randn(*flat[k].shape) * 0.02).astype(np.float32)
    batches = [synthetic_batch(20 + i, 2, 64, 2) for i in range(2)]
    jstate = jax_init_state(jm, jax_unflatten({k: jnp.asarray(v) for k, v in flat.items()}), cfg)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jstate, jlosses = jax.jit(jax_make_multi(jm, cfg, n_steps=2, target_pipeline="step"))(
        jstate, {k: jnp.asarray(v) for k, v in stacked.items()}, jax.random.PRNGKey(0))
    model = PPYOLO.from_config(cfg)
    model.load_state_dict(jax_params_to_state_dict(flat, model))
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, cfg)
    state, losses = make_multi_train_step(model, cfg, n_steps=2)(state, _stack(batches))
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(v), rtol=1e-3, err_msg=k)
    oihw = lambda k, v: hwio_to_oihw(np.asarray(v)) if np.ndim(v) == 4 else np.asarray(v)
    jparams = jax_flatten(jstate.params)
    sd = model.state_dict()
    for k in state.trainable:
        tol = 2e-3 if k.startswith("head.yolo_output_convs") else 0.2
        assert rel_l2(sd[k] - p0[k], oihw(k, jparams[k]) - p0[k].numpy()) <= tol, k
        assert rel_l2(state.velocity()[k], oihw(k, jstate.velocity[k])) <= tol, k
        assert rel_l2(state.ema[k] - p0[k], oihw(k, jstate.ema[k]) - p0[k].numpy()) <= tol, k
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            assert rel_l2(sd[k], jparams[k]) <= 1e-3, k


def test_warmup_leaves_the_state_and_the_trajectory_untouched():
    """``prepare`` on dummy units of both sizes (a run on the live state,
    then restored): every tensor, the generator and the step as before, and
    two steps after it equal two steps without it."""
    cfg = _dropblock_cfg()
    cfg.train_cfg = dict(cfg.train_cfg, batch_size=2)
    batches = [to_torch(synthetic_batch(30 + i, 2, 64, 2)) for i in range(2)]

    def run(warm):
        model = _model(cfg)
        state = init_train_state(model, cfg)
        gen = torch.Generator().manual_seed(9)
        unit = make_unit_step(model, cfg, state, gen)
        if warm:
            before, gen_before = _state_copy(state), gen.get_state()
            times = warmup_units(unit, cfg, torch.device("cpu"), sizes=[96, 64])
            assert sorted(times) == [64, 96] and len(unit.graphs.captures) == 2
            after = state.tensors()
            assert all(torch.equal(after[k], v) for k, v in before.items())
            assert torch.equal(gen.get_state(), gen_before) and state.step == 0
        for b in batches:
            state, _ = unit(state, b)
        return _state_copy(state)

    warm, cold = run(True), run(False)
    assert all(torch.equal(warm[k], cold[k]) for k in cold)


def test_graphed_step_refuses_another_state():
    cfg = mini2x_cfg()
    model = _model(cfg)
    state = init_train_state(model, cfg)
    unit = GraphedStep(make_train_step(model, cfg), state, None)
    other = init_train_state(model, cfg)
    with pytest.raises(ValueError, match="bound"):
        unit(other, to_torch(synthetic_batch(0, 2, 64, 2)))


def test_graphs_refresh_stale_caches_in_place():
    """A replay reads BN's eval affine and the packed DCN weight without a
    check, so ``Graphs`` recomputes them into the same tensors when a
    parameter was written in place (a direct ``load_state_dict`` here), and
    leaves them alone when nothing was."""
    cfg = mini2x_cfg()
    model = _model(cfg).eval()
    graphs = Graphs(lambda inp: {}, "cpu", model=model)
    bn = next(m for m in model.modules() if type(m).__name__ == "BatchNorm")
    dcn = next(m for m in model.modules() if getattr(m, "use_dcn", False))
    k = bn.eval_affine(torch.float32)[0]
    packed = dcn.packed_dcn_weight()
    k0, packed0 = k.clone(), packed.clone()
    graphs._refresh_caches()
    key = (bn._affine_key, dcn._packed_key)
    graphs._refresh_caches()   # nothing written: nothing recomputed
    assert (bn._affine_key, dcn._packed_key) == key
    sd = {n: v * 1.5 if v.is_floating_point() else v for n, v in model.state_dict().items()}
    model.load_state_dict(sd)
    graphs._refresh_caches()
    assert bn._affine[0] is k and dcn._packed is packed   # the tensors a graph reads
    fresh = _model(cfg).eval()
    fresh.load_state_dict(sd)
    want_k = next(m for m in fresh.modules()
                  if type(m).__name__ == "BatchNorm").eval_affine(torch.float32)[0]
    want_packed = next(m for m in fresh.modules()
                       if getattr(m, "use_dcn", False)).packed_dcn_weight()
    assert torch.equal(k, want_k) and torch.equal(packed, want_packed)
    assert not torch.equal(k, k0) and not torch.equal(packed, packed0)


def test_will_log_is_the_jax_rule():
    # train.py:269-270: a unit logs when it crosses a multiple of log_iter
    assert [s for s in range(0, 12, 4) if will_log(s, 4, 6)] == [4, 8]
    assert [s for s in range(6) if will_log(s, 1, 2)] == [1, 3, 5]
    assert not any(will_log(s, 2, 0) for s in range(6))
    assert dummy_batch(mini2x_cfg(), 64, 2, 3)["image"].shape == (3, 2, 64, 64, 3)


# ---------------------------------------------------------------- the entry

def test_entry_with_scan_steps_writes_and_resumes_bitwise(dataset, tmp_path):  # noqa: F811
    """``scan_steps=2`` with ``warmup_shapes``: one warmup row per size,
    losses logged at the units' ends (2, 4), checkpoints at 2 and 4, the
    eval at 4; 2 steps, a resume and 2 more equal 4 straight."""
    straight_dir = str(tmp_path / "straight")
    straight = train_entry.run_training(entry_cfg(dataset, scan_steps=2, warmup_shapes=True),
                                        weights_dir=straight_dir, device="cpu")
    assert straight.step == 4 and int(straight.step_t) == 4
    rows = [json.loads(line) for line in open(os.path.join(straight_dir, "metrics.jsonl"))]
    warm = [r for r in rows if "warmup_size" in r]
    assert [r["warmup_size"] for r in warm] == [64, 96]
    assert all(set(r) == {"warmup_size", "secs", "time"} for r in warm)
    assert [r["iter"] for r in rows if "total_loss" in r] == [2, 4]
    assert [r["iter"] for r in rows if "box_ap" in r] == [4]
    assert {"step00000002.npz", "step00000004.npz", "last_state.npz"} <= set(
        os.listdir(straight_dir))
    wdir = str(tmp_path / "w")
    first = train_entry.run_training(
        entry_cfg(dataset, scan_steps=2, max_iters=2, eval_iter=10 ** 9),
        weights_dir=wdir, device="cpu")
    assert first.step == 2
    resumed = train_entry.run_training(
        entry_cfg(dataset, scan_steps=2, eval_iter=10 ** 9,
                  resume_state=os.path.join(wdir, "last_state.npz")),
        weights_dir=wdir, device="cpu")
    assert resumed.step == 4 and int(resumed.step_t) == 4
    _equal_states(straight, resumed)


def test_cli_takes_scan_steps(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_entry, "run_training",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    train_entry.main(["--config", "1", "--use_gpu", "false", "--scan_steps", "2"])
    assert seen["cfg"].train_cfg["scan_steps"] == 2 and seen["device"] == "cpu"


# ---------------------------------------------------------------- serving and eval

def _detector_inputs():
    r = np.random.RandomState(0)
    images = r.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[90, 120], [64, 64], [120, 90], [200, 100]], np.float32)
    return images, sizes


def test_predict_pipelined_is_bitwise_predict_batch():
    cfg = mini2x_cfg()
    det = Detector(PPYOLO.from_config(cfg), _model(cfg, 3).state_dict(), cfg, target_size=64,
                   precision="bf16", device="cpu")
    images, sizes = _detector_inputs()
    got = det.predict_pipelined(images, sizes, group=2)
    want = np.concatenate([det.predict_batch(images[:2], sizes[:2]),
                           det.predict_batch(images[2:], sizes[2:])])
    assert got.shape == (4, 100, 6) and (got[..., 0] >= 0).any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="split"):
        det.predict_pipelined(images[:3], sizes[:3], group=2)


def test_predict_pipelined_matches_jax():
    """fp32 detections of two batches in one unit against the JAX
    package's scanned ``predict_pipelined`` on the same params, at
    ``test_golden``'s tolerances."""
    cfg = mini2x_cfg()
    jm = JaxPPYOLO.from_config(cfg)
    params = jm.init(jax.random.PRNGKey(2))
    flat = {k: np.asarray(v) for k, v in jax_flatten(params).items()}
    model = PPYOLO.from_config(cfg)
    sd = jax_params_to_state_dict(flat, model)
    det = Detector(model, sd, cfg, target_size=64, device="cpu")
    jdet = JaxDetector(jm, params, cfg, target_size=64)
    images, sizes = _detector_inputs()
    got = det.predict_pipelined(images, sizes, group=2)
    want = jdet.predict_pipelined(images, sizes, group=2)
    assert (want[..., 0] >= 0).any()
    assert_pred_close(got, want)


@pytest.mark.parametrize("scan_group", [2, 3])
def test_run_eval_scan_group_equals_scan_group_1(dataset, tmp_path, scan_group):  # noqa: F811
    """6 images in batches of 4: one unit of 2 batches (scan_group 2) or
    a short group run batch by batch (3): the stats and every shard file as
    ``scan_group=1`` writes them."""
    cfg = entry_cfg(dataset)
    sd = _model(cfg, 4).state_dict()
    one = eval_entry.run_eval(cfg, state_dict=sd, device="cpu", result_dir=str(tmp_path / "1"))
    got = eval_entry.run_eval(cfg, state_dict=sd, device="cpu", scan_group=scan_group,
                              result_dir=str(tmp_path / "g"))
    np.testing.assert_array_equal(got, one)
    shards = sorted(os.listdir(tmp_path / "1" / "bbox"))
    assert len(shards) == 6 and shards == sorted(os.listdir(tmp_path / "g" / "bbox"))
    for f in shards:
        assert (open(tmp_path / "1" / "bbox" / f).read()
                == open(tmp_path / "g" / "bbox" / f).read()), f
