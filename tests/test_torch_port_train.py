"""The port's training slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances, and why:

* elementwise parts (train-mode BN, DropBlock from JAX's own uniforms,
  targets, the loss terms, LR, SGD, EMA) are fp32 computations of the same
  expressions: rtol 1e-5 or tighter (targets and LR exact);
* one full ``make_train_step`` on the mini-2x configuration (ResNet18-vd
  with DCNv2 in stage 5 and the full ppyolo_2x head, as
  ``tests/test_overfit.py::Mini2xCfg``; DropBlock off, EMA on) from bridged
  JAX params.  The loss terms agree to 1e-3 (measured <= 2e-4) and the
  output convs' gradients to 2e-3 (measured <= 2e-4).  Deeper gradients do
  not: this randomly initialized train-mode network is ill-conditioned in
  fp32 -- a relative change of 1e-7 in every parameter moves the exact
  (fp64) gradients of its deep leaves by 0.2-0.7%, and fp32 rounding moves
  both frameworks' gradients 1-6% from the fp64 ones, in different
  directions (measured on seven seeds and sizes).  Every leaf's velocity,
  update and EMA move is therefore held at relative L2 0.2, which still
  fails any gradient that is wrong in form; BN running stats, which only
  the forward sets, at 1e-3 (measured <= 1.3e-4).
"""
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from configs import PPYOLO_2x_Config
from ppyolo_tpu.data.targets import gt2yolo_targets as jax_targets_host
from ppyolo_tpu.data.targets import gt2yolo_targets_device as jax_targets_device
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.ops.blocks import drop_block as jax_drop_block
from ppyolo_tpu.ops.conv import batch_norm as jax_batch_norm
from ppyolo_tpu.ops.ema import ema_update as jax_ema_update
from ppyolo_tpu.ops.module import ParamPolicy as JaxParamPolicy
from ppyolo_tpu.ops.module import flatten_tree as jax_flatten
from ppyolo_tpu.ops.module import unflatten_tree as jax_unflatten
from ppyolo_tpu.train import init_train_state as jax_init_state
from ppyolo_tpu.train import make_train_step as jax_make_step
from ppyolo_tpu.train.losses import total_loss as jax_total_loss
from ppyolo_tpu.train.lr_schedule import make_lr_fn as jax_lr_fn
from ppyolo_tpu.train.optimizer import sgd_momentum_update
from ppyolo_tpu.train.train_step import build_loss as jax_build_loss

from ppyolo_tpu_torch.checkpoint.bridge import hwio_to_oihw, jax_params_to_state_dict
from ppyolo_tpu_torch.data.targets import gt2yolo_targets_device
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.ops.blocks import drop_block, drop_block_uniform
from ppyolo_tpu_torch.ops.ema import ema_apply, ema_update
from ppyolo_tpu_torch.ops.module import BatchNorm, ParamPolicy
from ppyolo_tpu_torch.train.loop import run_training
from ppyolo_tpu_torch.train.lr_schedule import make_lr_fn
from ppyolo_tpu_torch.train.optimizer import SGD
from ppyolo_tpu_torch.train.train_step import (build_loss, init_train_state,
                                               make_train_step)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def mini2x_cfg():
    """ppyolo_2x's feature set at ResNet18-vd depth (tests/test_overfit.py
    ``Mini2xCfg``), with EMA on and an LR that moves the params."""
    cfg = PPYOLO_2x_Config()
    cfg.num_classes = 2
    cfg.backbone_type = "Resnet18Vd"
    cfg.backbone = dict(norm_type="bn", feature_maps=[3, 4, 5], dcn_v2_stages=[5],
                        freeze_at=0, freeze_norm=False, norm_decay=0.0)
    cfg.head = dict(cfg.head, num_classes=2, drop_block=False, in_channels=[512, 256, 128])
    cfg.gt2YoloTarget = dict(cfg.gt2YoloTarget, num_classes=2)
    cfg.learningRate = dict(base_lr=0.01, PiecewiseDecay=dict(gamma=0.1, milestones=[10 ** 9]),
                            LinearWarmup=dict(start_factor=0.5, steps=10))
    cfg.use_ema = True
    return cfg


def synthetic_batch(seed, batch, size, num_classes, n_gt=4):
    r = np.random.RandomState(seed)
    gt_bbox = np.zeros((batch, 50, 4), np.float32)
    gt_bbox[:, :n_gt, :2] = r.uniform(0.2, 0.8, (batch, n_gt, 2))
    gt_bbox[:, :n_gt, 2:] = r.uniform(0.05, 0.5, (batch, n_gt, 2))
    gt_score = np.zeros((batch, 50), np.float32)
    gt_score[:, :n_gt] = 1.0
    return {"image": r.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
            "gt_bbox": gt_bbox,
            "gt_class": r.randint(0, num_classes, (batch, 50)).astype(np.int32),
            "gt_score": gt_score}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- targets

def _collision_gt():
    """Padded gts with collisions: gts 0/1 share a cell and best anchor (the
    later wins the fields, both class bits stay), gt 2 is an invalid row
    (score 0) on the same cell, gt 3 a wide box that takes extra anchors
    with iou_thresh < 1."""
    r = np.random.RandomState(3)
    b, m = 2, 12
    gt_bbox = np.zeros((b, m, 4), np.float32)
    gt_bbox[:, :8, :2] = r.uniform(0.05, 0.95, (b, 8, 2))
    gt_bbox[:, :8, 2:] = r.uniform(0.02, 0.6, (b, 8, 2))
    gt_bbox[:, 1] = gt_bbox[:, 0] + np.array([0.001, 0.001, 0.002, -0.001], np.float32)
    gt_bbox[:, 2] = gt_bbox[:, 0]
    gt_bbox[:, 3, 2:] = (0.5, 0.45)
    gt_class = r.randint(0, 5, (b, m)).astype(np.int32)
    gt_class[:, 1] = (gt_class[:, 0] + 1) % 5
    gt_score = np.zeros((b, m), np.float32)
    gt_score[:, :8] = 1.0
    gt_score[:, 2] = 0.0
    gt_score[1, 5] = 0.7
    return gt_bbox, gt_class, gt_score


@pytest.mark.parametrize("iou_thresh", [1.0, 0.3])
def test_targets_match_both_jax_builders(iou_thresh):
    cfg = PPYOLO_2x_Config()
    args = (cfg.head["anchors"], cfg.head["anchor_masks"], [32, 16, 8], 5)
    gt_bbox, gt_class, gt_score = _collision_gt()
    host = jax_targets_host(gt_bbox, gt_class, gt_score, (320, 320), *args,
                            iou_thresh=iou_thresh)
    dev = jax_targets_device(jnp.asarray(gt_bbox), jnp.asarray(gt_class),
                             jnp.asarray(gt_score), (320, 320), *args, iou_thresh=iou_thresh)
    got = gt2yolo_targets_device(torch.from_numpy(gt_bbox), torch.from_numpy(gt_class),
                                 torch.from_numpy(gt_score), (320, 320), *args,
                                 iou_thresh=iou_thresh)
    for g, h, d in zip(got, host, dev):
        assert g.dtype == torch.float32 and tuple(g.shape) == h.shape
        np.testing.assert_allclose(g.numpy(), h, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(d), rtol=0, atol=1e-6)
    # the collision left a multi-hot class plane somewhere
    assert max(float(t[..., 6:].sum(-1).max()) for t in got) >= 2.0


# ---------------------------------------------------------------- losses

def _loss_inputs(seed=0, size=64):
    cfg = PPYOLO_2x_Config()
    cfg.num_classes = 3
    cfg.head = dict(cfg.head, num_classes=3)
    cfg.gt2YoloTarget = dict(cfg.gt2YoloTarget, num_classes=3)
    r = np.random.RandomState(seed)
    outs = []
    for ds in (32, 16, 8):
        s = size // ds
        o = r.randn(2, s, s, 3 * (6 + 3)).astype(np.float32)
        outs.append(o)
    outs[0][0, 0, 0, 3 + 4] = 30.0        # a saturated objectness logit
    outs[1][1, 1, 1, 3 + 5] = 30.0        # a saturated class logit
    outs[2][0, 2, 3, 3 + 5] = -30.0
    b = synthetic_batch(seed, 2, size, 3)
    tc = cfg.gt2YoloTarget
    targets = jax_targets_host(b["gt_bbox"], b["gt_class"], b["gt_score"], (size, size),
                               tc["anchors"], tc["anchor_masks"], tc["downsample_ratios"], 3)
    return cfg, outs, targets, b["gt_bbox"]


def test_losses_and_their_gradients_match_jax():
    cfg, outs, targets, gt_bbox = _loss_inputs()
    jm = JaxPPYOLO.from_config(cfg)
    jloss = jax_build_loss(cfg)

    def jtotal(os_):
        d = jloss(list(os_), [jnp.asarray(t) for t in targets], jnp.asarray(gt_bbox),
                  jm.head.mask_anchors, 3)
        return jax_total_loss(d), d

    (jt, jd), jg = jax.value_and_grad(jtotal, has_aux=True)([jnp.asarray(o) for o in outs])
    model = PPYOLO.from_config(cfg)
    touts = [nchw(o).requires_grad_() for o in outs]
    d = build_loss(cfg)(touts, [torch.from_numpy(t) for t in targets],
                        torch.from_numpy(gt_bbox), model.head.mask_anchors, 3)
    assert list(d) == ["loss_xy", "loss_wh", "loss_obj", "loss_cls", "loss_iou",
                       "loss_iou_aware"]
    total = sum(d.values())
    for k, v in d.items():
        assert np.isfinite(float(v))
        np.testing.assert_allclose(float(v), float(jd[k]), rtol=1e-5)
    grads = torch.autograd.grad(total, touts)
    for g, j in zip(grads, jg):
        assert np.isfinite(nhwc(g)).all()
        np.testing.assert_allclose(nhwc(g), np.asarray(j), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- BN, DropBlock

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batch_norm_matches_jax(dtype):
    r = np.random.RandomState(1)
    x = (r.randn(2, 5, 6, 8) * 2.0 + 3.0).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = r.randn(8).astype(np.float32)
    mean = r.randn(8).astype(np.float32)
    var = r.uniform(0.5, 2.0, 8).astype(np.float32)
    cot = r.randn(2, 5, 6, 8).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def fn(x_, s_, b_):
        return jax_batch_norm(x_, s_, b_, jnp.asarray(mean), jnp.asarray(var), train=True)

    (jy, jm, jv), vjp = jax.vjp(fn, jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
                                jnp.asarray(bias, jdt))
    jgx, jgs, jgb = vjp((jnp.asarray(cot, jdt), jnp.zeros_like(jm), jnp.zeros_like(jv)))
    tdt = getattr(torch, dtype)
    bn = BatchNorm(8).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xt = nchw(x, tdt).requires_grad_()
    w = torch.from_numpy(scale).to(tdt).requires_grad_()
    b = torch.from_numpy(bias).to(tdt).requires_grad_()
    torch.func.functional_call(bn, {"weight": w, "bias": b}, (xt,))
    y = torch.func.functional_call(bn, {"weight": w, "bias": b}, (xt,))
    assert y.dtype == tdt and bn.running_mean.dtype == torch.float32
    gx, gw, gb = torch.autograd.grad(y, (xt, w, b), nchw(cot, tdt))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(nhwc(y), np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(nhwc(gx), np.asarray(jgx, np.float32), **tol)
    np.testing.assert_allclose(gw.float().numpy(), np.asarray(jgs, np.float32), **tol)
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(jgb, np.float32), **tol)
    # two forwards: the running stats moved twice from the same batch stats
    (_, jm2, jv2), _ = jax.vjp(lambda *a: jax_batch_norm(*a, train=True),
                               jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
                               jnp.asarray(bias, jdt), jm, jv)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jm2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jv2), rtol=1e-5, atol=1e-6)


def test_drop_block_matches_jax_on_its_uniforms():
    r = np.random.RandomState(2)
    x = r.randn(2, 8, 8, 16).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_drop_block(jnp.asarray(x), key, block_size=3, keep_prob=0.9))
    u = np.asarray(jax.random.uniform(key, x.shape))      # the draw drop_block makes
    got = drop_block_uniform(nchw(x), nchw(u), block_size=3, keep_prob=0.9)
    assert (want == 0).any() and (want != 0).any()
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)
    # the generator form draws the same kind of uniforms
    gen = torch.Generator().manual_seed(0)
    y = drop_block(nchw(x), gen, block_size=3, keep_prob=0.9)
    assert y.shape == (2, 16, 8, 8) and (y == 0).any()


def test_head_drop_block_slots_match_jax():
    """DropBlock sits where the JAX head puts it and runs in training only."""
    cfg = PPYOLO_2x_Config()
    jm = JaxPPYOLO.from_config(cfg)
    port = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(0))
    for jb, pb in zip(jm.head.det_blocks, port.head.detection_blocks):
        assert [k for k, _ in jb.seq] == [k for k, _ in pb.seq]
        assert "drop" in [k for k, _ in pb.seq]
    blk = port.head.detection_blocks[1]
    x = torch.randn(1, blk.layers["1"].cin - 2, 4, 4)
    gen = torch.Generator().manual_seed(0)
    blk.eval()
    a, _ = blk(x, gen)
    b, _ = blk(x, gen)
    assert torch.equal(a, b)
    blk.train()
    a, _ = blk(x, gen)
    b, _ = blk(x, gen)
    assert not torch.equal(a, b)


# ---------------------------------------------------------------- LR, SGD, EMA

def test_lr_schedule_matches_jax():
    cfg = PPYOLO_2x_Config()
    steps = [0, 1, 2, 7, 3999, 4000, 4001, 123456, 399999, 400000, 449999, 450000, 500000]
    want, got = jax_lr_fn(cfg.learningRate), make_lr_fn(cfg.learningRate)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-7, atol=0)


def test_sgd_with_policy_and_ema_match_jax():
    r = np.random.RandomState(4)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.weight": (2, 2), "b.bn.weight": (5,)}
    pols = {"a.weight": (1.0, 1.0, True), "a.bias": (2.0, 0.0, True),
            "b.weight": (1.0, 1.0, False), "b.bn.weight": (0.5, 0.0, True)}
    p0 = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: r.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(4)]
    lr_fn = jax_lr_fn(dict(base_lr=0.1, PiecewiseDecay=dict(gamma=0.1, milestones=[3]),
                           LinearWarmup=dict(start_factor=0.2, steps=2)))
    jpol = {k: JaxParamPolicy(*v) for k, v in pols.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jvel = {k: jnp.zeros_like(v) for k, v in jp.items()}
    train = [k for k in p0 if pols[k][2]]
    jema = {k: jp[k] for k in train}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = SGD(params, {k: ParamPolicy(*v) for k, v in pols.items()},
              momentum=0.9, l2_factor=0.0005)
    ema = {k: params[k].detach().clone() for k in train}
    plr = make_lr_fn(dict(base_lr=0.1, PiecewiseDecay=dict(gamma=0.1, milestones=[3]),
                          LinearWarmup=dict(start_factor=0.2, steps=2)))
    for t, g in enumerate(grads):
        jp, jvel = sgd_momentum_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jvel,
                                       jpol, lr_fn(t), momentum=0.9, l2_factor=0.0005)
        jema = jax_ema_update(jema, {k: jp[k] for k in train}, jnp.asarray(t, jnp.int32),
                              0.9998)
        opt.step({k: torch.from_numpy(g[k]) for k in params},
                 torch.tensor(np.float32(plr(t))))
        ema_update(ema, params, t, 0.9998)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        if k in train:
            np.testing.assert_allclose(opt.bufs[k].numpy(),
                                       np.asarray(jvel[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(jema[k]), rtol=1e-6,
                                       atol=1e-7)
    assert np.array_equal(params["b.weight"].detach().numpy(), p0["b.weight"])
    merged = ema_apply({k: p.detach() for k, p in params.items()}, ema)
    assert set(merged) == set(params) and merged["b.weight"] is params["b.weight"].detach() \
        or torch.equal(merged["b.weight"], params["b.weight"].detach())
    assert all(merged[k] is ema[k] for k in train)


@pytest.mark.parametrize("backbone", [
    dict(freeze_at=0), dict(freeze_at=5),
    dict(freeze_at=2, freeze_norm=True, lr_mult_list=(0.1, 0.2, 0.5, 1.0))])
def test_policy_tree_matches_jax(backbone):
    cfg = PPYOLO_2x_Config()
    cfg.backbone = dict(cfg.backbone, **backbone)
    want = {k: (p.lr_mult, p.wd_mult, p.trainable)
            for k, p in JaxPPYOLO.from_config(cfg).flat_policy().items()}
    model = PPYOLO.from_config(cfg)
    flat = model.flat_policy()
    assert {k: (p.lr_mult, p.wd_mult, p.trainable) for k, p in flat.items()} == want
    assert set(flat) == set(model.state_dict())
    for k, p in model.named_parameters():
        assert p.requires_grad == flat[k].trainable, k


# ---------------------------------------------------------------- the train step

@pytest.fixture(scope="module")
def mini2x_step():
    """One JAX train step on mini-2x from PRNGKey(0) params with perturbed
    offset convs (so every DCN interpolates), fp32, and the flat params."""
    cfg = mini2x_cfg()
    jm = JaxPPYOLO.from_config(cfg)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jm.init(jax.random.PRNGKey(0))).items()}
    r = np.random.RandomState(7)
    for k in sorted(flat):
        if k.endswith("conv_offset.weight") or k.endswith("conv_offset.bias"):
            flat[k] = (r.randn(*flat[k].shape) * 0.02).astype(np.float32)
    batch = synthetic_batch(0, 2, 64, 2)
    state = jax_init_state(jm, jax_unflatten({k: jnp.asarray(v) for k, v in flat.items()}), cfg)
    state, losses = jax.jit(jax_make_step(jm, cfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    to_np = lambda t: {k: np.asarray(v) for k, v in t.items()}
    return dict(cfg=cfg, flat=flat, batch=batch, losses={k: float(v) for k, v in losses.items()},
                params=to_np(jax_flatten(state.params)), velocity=to_np(state.velocity),
                ema=to_np(state.ema))


def _oihw(k, v):
    return hwio_to_oihw(v) if v.ndim == 4 else v


def _port_model(cfg, flat):
    model = PPYOLO.from_config(cfg)
    model.load_state_dict(jax_params_to_state_dict(flat, model))
    return model


def test_train_step_matches_jax(mini2x_step):
    s = mini2x_step
    model = _port_model(s["cfg"], s["flat"])
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, s["cfg"])
    state, losses = make_train_step(model, s["cfg"])(state, to_torch(s["batch"]))
    assert state.step == 1 and set(state.trainable) == set(s["velocity"])
    for k, v in s["losses"].items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-3, err_msg=k)
    vel = state.velocity()
    sd = model.state_dict()
    for k, jv in s["velocity"].items():
        tol = 2e-3 if k.startswith("head.yolo_output_convs") else 0.2
        assert rel_l2(vel[k], _oihw(k, jv)) <= tol, k
        want_move = _oihw(k, s["params"][k]) - p0[k].numpy()
        assert rel_l2(sd[k] - p0[k], want_move) <= tol, k
        assert rel_l2(state.ema[k] - p0[k], _oihw(k, s["ema"][k]) - p0[k].numpy()) <= tol, k
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            assert rel_l2(sd[k], s["params"][k]) <= 1e-3, k


def test_bf16_train_step_keeps_fp32_masters(mini2x_step):
    """Mixed precision: the forward runs on bf16 copies, the masters and BN
    running stats stay fp32, and the losses stay near the fp32 step's: the
    total within 2e-2, each term within 0.1 (bf16 rounding through this
    random network moves the JAX package's own bf16 loss terms up to 7%
    from its fp32 ones on these inputs)."""
    s = mini2x_step
    model = _port_model(s["cfg"], s["flat"])
    state = init_train_state(model, s["cfg"])
    state, losses = make_train_step(model, s["cfg"], compute_dtype=torch.bfloat16)(
        state, to_torch(s["batch"]))
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in state.velocity().values())
    for k, v in s["losses"].items():
        tol = 2e-2 if k in ("total_loss", "lr") else 0.1
        np.testing.assert_allclose(float(losses[k]), v, rtol=tol, err_msg=k)


def test_run_training_on_cpu_takes_steps(caplog):
    cfg = mini2x_cfg()
    cfg.head = dict(cfg.head, drop_block=True)
    cfg.train_cfg = dict(cfg.train_cfg, log_iter=1, precision="fp32")
    batches = (synthetic_batch(i, 2, 64, 2) for i in range(5))
    with caplog.at_level(logging.INFO, logger="ppyolo_tpu_torch.train.loop"):
        state, eval_sd = run_training(cfg, batches, device="cpu", max_iters=2)
    assert state.step == 2
    assert len([r for r in caplog.records if "imgs/s" in r.getMessage()]) == 2
    sd = state.model.state_dict()
    assert set(eval_sd) == set(sd)
    for k, v in eval_sd.items():
        want = state.ema[k] if k in state.ema else sd[k]
        assert torch.equal(v, want) and torch.isfinite(v).all(), k
