"""GroupNorm, affine_channel and mish in the port (``ops/module.py::
GroupNorm``, ``AffineChannel``; ``ops/conv.py::ConvNormAct``, ``mish``)
against the JAX package's ``ConvNormAct``, on the CPU, and a whole
ppyolo_2x configuration with ``norm_type="gn"``.

Tolerances, and why:

* one layer (1x1 and 3x3, strides 1 and 2, a DCN layer; C = 32, 64, 96):
  fp64 against JAX under x64 within 1e-5 relative L2: JAX computes the GN
  statistics in fp32 even under x64 (``astype(float32)``,
  ``ppyolo_tpu/ops/conv.py:156``), the port in fp64 (measured <= 2e-7);
  affine_channel and mish are fp64 on both sides (measured ~1e-15).  fp32
  within 1e-5 (measured <= 1.1e-6), bf16 within 2e-2 (measured <= 6.6e-3);
* GN's gradients against ``jax.grad`` in fp64, 1e-5 (JAX's fp32 statistics);
* the mini ppyolo_2x-GN (ResNet18-vd trunk with DCN in stage 5, the full
  2x head, 64 px): fp64 maps within the model tests' 1e-4 of JAX x64 and
  the detections as there; the bf16 maps' gap to the exact forward at most
  1.1x JAX's per level (the yardstick of
  ``test_torch_port_model.py::test_bf16_gap_to_jax_is_rounding_order``, in
  every head mode); one fp32 ``make_train_step`` against JAX's held as
  ``test_torch_port_train.py::test_train_step_matches_jax`` holds the BN
  model's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from ppyolo_tpu.eval.optimize import fold_bn_params as jax_fold_bn
from ppyolo_tpu.eval.optimize import optimize_for_inference as jax_optimize
from ppyolo_tpu.eval.optimize import quantize_params_int8 as jax_quantize
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.models.head import head_decompose as jax_head_decompose
from ppyolo_tpu.ops.conv import ConvNormAct as JaxConvNormAct
from ppyolo_tpu.ops.conv import mish as jax_mish
from ppyolo_tpu.ops.module import Ctx
from ppyolo_tpu.ops.module import flatten_tree as jax_flatten
from ppyolo_tpu.ops.module import unflatten_tree as jax_unflatten
from ppyolo_tpu.train import init_train_state as jax_init_state
from ppyolo_tpu.train import make_train_step as jax_make_step

from ppyolo_tpu_torch.checkpoint.bridge import (hwio_to_oihw, jax_params_to_state_dict,
                                                state_dict_to_jax_params)
from ppyolo_tpu_torch.eval.detector import Detector
from ppyolo_tpu_torch.eval.optimize import fold_bn_params, quantize_params_int8
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.models.head import head_decompose
from ppyolo_tpu_torch.ops.conv import ConvNormAct, mish, softplus
from ppyolo_tpu_torch.ops.module import GroupNorm
from ppyolo_tpu_torch.ops.stem import stem_eligible
from ppyolo_tpu_torch.train.train_step import init_train_state, make_train_step
from ppyolo_tpu_torch.utils.mfu import kernel_flops

from test_torch_port_train import mini2x_cfg, rel_l2, synthetic_batch, to_torch

CL = torch.channels_last
LAYERS = [(1, 1, 32, False), (3, 2, 64, False), (3, 1, 96, True), (3, 1, 32, False)]
NORM_ACTS = [("gn", "relu"), ("gn", "mish"), ("affine_channel", "leaky"),
             ("affine_channel", "mish")]
PRECISIONS = {"fp64": 1e-5, "fp32": 1e-5, "bf16": 2e-2}
SIZE = 64


def gn_cfg(base=None):
    """A ppyolo_2x configuration with GroupNorm in the backbone and the head
    (default: the mini-2x of ``test_torch_port_train.py``)."""
    cfg = base or mini2x_cfg()
    cfg.backbone = dict(cfg.backbone, norm_type="gn")
    cfg.head = dict(cfg.head, norm_type="gn")
    return cfg


def _perturbed(flat, seed):
    """Random norm affines (around 1 and 0) and small offset convs, so each
    layer's norm and each DCN's sampling do something."""
    r = np.random.RandomState(seed)
    out = dict(flat)
    for k in sorted(out):
        if "conv_offset" in k:
            out[k] = (r.randn(*out[k].shape) * 0.02).astype(np.float32)
        elif k.endswith((".gn.weight", ".af.weight")):
            out[k] = (1.0 + 0.3 * r.randn(*out[k].shape)).astype(np.float32)
        elif k.endswith((".gn.bias", ".af.bias")):
            out[k] = (0.3 * r.randn(*out[k].shape)).astype(np.float32)
    return out


def _jax_tree(flat, dtype):
    return jax_unflatten({k: jnp.asarray(np.asarray(v, dtype)) for k, v in flat.items()})


# ---------------------------------------------------------------- one layer

def _layer_pair(norm, act, k, stride, c, dcn):
    """JAX ConvNormAct ``l`` and the port's (held as ``holder.l``, so the
    bridge sees the ``l.conv.weight`` path), with the same perturbed params."""
    jm = JaxConvNormAct(c, c, k, stride=stride, norm=norm, act=act, use_dcn=dcn, name="l")
    flat = {f"l.{k_}": np.asarray(v)
            for k_, v in jax_flatten(jm.init(jax.random.PRNGKey(c + k))).items()}
    flat = _perturbed(flat, c)
    holder = nn.Module()
    holder.l = ConvNormAct(c, c, k, stride=stride, norm=norm, act=act, use_dcn=dcn)
    holder.load_state_dict(jax_params_to_state_dict(flat, holder))
    return jm, {k_[2:]: v for k_, v in flat.items()}, holder.l


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("k,stride,c,dcn", LAYERS)
@pytest.mark.parametrize("norm,act", NORM_ACTS)
def test_layer_matches_jax(norm, act, k, stride, c, dcn, precision):
    jm, flat, tm = _layer_pair(norm, act, k, stride, c, dcn)
    x = np.random.RandomState(c).randn(2, 12, 12, c).astype(np.float32)
    jdt, tdt = {"fp64": (np.float64, torch.float64), "fp32": (np.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[precision]
    if precision == "fp64":
        with jax.enable_x64(True):
            want = jm.apply(_jax_tree(flat, np.float64), jnp.asarray(x.astype(np.float64)),
                            Ctx(train=False))
            want = np.asarray(want)
    else:
        want = np.asarray(jm.apply(_jax_tree(flat, jdt), jnp.asarray(x).astype(jdt),
                                   Ctx(train=False)).astype(jnp.float32))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).contiguous(memory_format=CL)
    with torch.no_grad():
        got = tm.to(tdt)(tx).permute(0, 2, 3, 1).double().numpy()
    assert got.shape == want.shape
    assert rel_l2(got, want) <= PRECISIONS[precision], rel_l2(got, want)


def test_softplus_and_mish_follow_jax_over_the_fp32_range():
    """JAX's softplus is ``logaddexp(x, 0)``; ``F.softplus`` returns x past
    20.  The port's is JAX's expression op by op, so it never switches.
    Over every quarter fp32 exponent of both signs (2^-126 to 2^127) and a
    fine grid of [-30, 30], softplus meets JAX's within 2 ulp and mish
    within 4 (measured: 2 and 4; the two libraries' exp and log1p) wherever
    both are normal; XLA on the CPU flushes subnormal values to zero (mish
    of x within a few smallest normals of 0 comes out 0), so elsewhere the
    two agree within 4 smallest normals.  In fp64 mish agrees to 1e-15."""
    mags = np.float32(2.0) ** np.arange(-126, 128, 0.25, dtype=np.float32)
    x = np.concatenate([-mags[::-1], [0.0], mags, np.linspace(-30, 30, 6001)]).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    for port, ref, ulp in ((softplus, jax.nn.softplus, 2), (mish, jax_mish, 4)):
        want = np.asarray(ref(jnp.asarray(x)))
        got = port(torch.from_numpy(x)).numpy()
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got))
        normal = fin & (np.abs(want) >= tiny) & (np.abs(got) >= tiny)
        np.testing.assert_array_max_ulp(got[normal], want[normal], maxulp=ulp)
        assert np.abs(got[fin & ~normal] - want[fin & ~normal]).max(initial=0.0) < 4 * tiny
    with jax.enable_x64(True):
        x64 = x.astype(np.float64)
        np.testing.assert_allclose(mish(torch.from_numpy(x64)).numpy(),
                                   np.asarray(jax_mish(jnp.asarray(x64))), rtol=1e-15,
                                   atol=1e-300)


@pytest.mark.parametrize("freeze_norm", [False, True])
@pytest.mark.parametrize("norm", ["gn", "affine_channel"])
def test_policy_and_requires_grad_match_jax(norm, freeze_norm):
    for frozen in (False, True):
        jm = JaxConvNormAct(64, 64, 3, norm=norm, act="relu", lr_mult=0.5,
                            freeze_norm=freeze_norm, name="l")
        jm.frozen = frozen
        tm = ConvNormAct(64, 64, 3, norm=norm, act="relu", lr_mult=0.5,
                         freeze_norm=freeze_norm)
        tm.freeze(frozen)
        want = {k: (p.lr_mult, p.wd_mult, p.trainable)
                for k, p in jax_flatten(jm.param_policy()).items()}
        from ppyolo_tpu_torch.ops.module import flatten_tree

        got = {k: (p.lr_mult, p.wd_mult, p.trainable)
               for k, p in flatten_tree(tm.param_policy()).items()}
        assert got == want
        assert set(got) == set(tm.state_dict())
        for k, p in tm.named_parameters():
            assert p.requires_grad == got[k][2], (k, frozen, freeze_norm)
    # init: ones and zeros, as JAX's
    name = "gn" if norm == "gn" else "af"
    jp = jax_flatten(jm.init(jax.random.PRNGKey(0)))
    tm.init_parameters(torch.Generator().manual_seed(0))
    for leaf in ("weight", "bias"):
        np.testing.assert_array_equal(getattr(getattr(tm, name), leaf).detach().numpy(),
                                      np.asarray(jp[f"{name}.{leaf}"]))


def test_group_norm_gradients_match_jax_grad():
    jm, flat, tm = _layer_pair("gn", "mish", 3, 1, 64, False)
    r = np.random.RandomState(3)
    x = r.randn(2, 10, 10, 64)
    cot = r.randn(2, 10, 10, 64)
    with jax.enable_x64(True):
        def loss(p, x_):
            return jnp.sum(jm.apply(p, x_, Ctx(train=False)) * jnp.asarray(cot))

        jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(_jax_tree(flat, np.float64), jnp.asarray(x))
        jg = {k: np.asarray(v) for k, v in jax_flatten(jg_p).items()}
        jg_x = np.asarray(jg_x)
    tm = tm.double()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=CL).requires_grad_()
    out = tm(tx)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert rel_l2(tx.grad.permute(0, 2, 3, 1).numpy(), jg_x) <= 1e-5
    for k, p in tm.named_parameters():
        want = hwio_to_oihw(jg[k]) if p.ndim == 4 else jg[k]
        assert rel_l2(p.grad.numpy(), want) <= 1e-5, k


def test_group_norm_statistics_dtype_and_layout():
    """fp32 statistics for bf16 input (the output one rounding of the fp32
    result), fp64 for fp64; the group view of a channels_last input is not
    a copy, and the output keeps the layout."""
    gn = GroupNorm(64)
    with torch.no_grad():
        gn.weight.copy_(torch.linspace(0.5, 1.5, 64))
        gn.bias.copy_(torch.linspace(-1, 1, 64))
    x = (torch.randn(2, 64, 9, 7, generator=torch.Generator().manual_seed(0)) * 3 + 5)
    x = x.contiguous(memory_format=CL)
    y64 = gn.double()(x.double())
    assert y64.dtype == torch.float64 and y64.is_contiguous(memory_format=CL)
    y16 = gn.float()(x.bfloat16())
    want = gn(x.bfloat16().float()).bfloat16()
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, want)
    assert x.view(2, 32, 2, 9, 7).data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="groups"):
        GroupNorm(48)


def test_forward_parts_applies_the_norm():
    """``forward_parts`` (the head's virtual concat) normalizes the summed
    parts as ``forward`` normalizes the concat: fp64 within 1e-12, under
    each norm; JAX's ``apply_parts`` does the same in fp32."""
    for norm, act in NORM_ACTS:
        jm, flat, tm = _layer_pair(norm, act, 1, 1, 96, False)
        r = np.random.RandomState(8)
        parts = [r.randn(2, 11, 11, 64), r.randn(1, 11, 11, 32)]
        tparts = [torch.from_numpy(p).permute(0, 3, 1, 2) for p in parts]
        full = torch.cat([tparts[0], tparts[1].expand(2, -1, -1, -1)], 1)
        with torch.no_grad():
            tm = tm.double()
            got, want = tm.forward_parts(tparts), tm(full)
        assert float((got - want).abs().max()) <= 1e-12
        jp = _jax_tree(flat, np.float32)
        jgot = np.asarray(jm.apply_parts(jp, [jnp.asarray(p, jnp.float32) for p in parts],
                                         Ctx(train=False)))
        assert rel_l2(got.permute(0, 2, 3, 1).numpy(), jgot) <= 1e-5


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def mini_gn():
    """The mini ppyolo_2x-GN: JAX params from PRNGKey(0) with perturbed norm
    affines and offset convs, the port model through the bridge, 64 px
    inputs and JAX's fp32 train step on one batch."""
    cfg = gn_cfg()
    jm = JaxPPYOLO.from_config(cfg)
    flat = _perturbed({k: np.asarray(v) for k, v in jax_flatten(jm.init(jax.random.PRNGKey(0))).items()}, 1)
    images = np.random.RandomState(2).rand(2, SIZE, SIZE, 3).astype(np.float32)
    im_size = np.array([[480, 640], [SIZE, SIZE]], np.float32)
    return dict(cfg=cfg, jm=jm, flat=flat, images=images, im_size=im_size)


def _port(s, dtype=torch.float32):
    model = PPYOLO.from_config(s["cfg"])
    model.load_state_dict(jax_params_to_state_dict(s["flat"], model))
    return model.to(dtype, memory_format=CL).eval()


def _jax_run(s, params, images, mode="off"):
    jm = s["jm"]

    def both(p, x, sz):
        ctx = Ctx(train=False)
        feats = jm.features(p, x, ctx)
        return (jm.head.get_prediction(p["head"], feats, sz, ctx),
                jm.head.get_outputs(p["head"], feats, ctx))

    with jax_head_decompose(mode):
        pred, outs = jax.jit(both)(params, jnp.asarray(images), jnp.asarray(s["im_size"]))
    return np.asarray(pred.astype(jnp.float32)), [np.asarray(o).astype(np.float64)
                                                  for o in outs]


def _exact(s):
    if "exact" not in s:
        with jax.enable_x64(True):
            s["exact"] = _jax_run(s, _jax_tree(s["flat"], np.float64),
                                  s["images"].astype(np.float64))
    return s["exact"]


def _port_run(model, s, dtype):
    x = torch.from_numpy(s["images"]).to(dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        maps = [o.double().permute(0, 2, 3, 1).numpy() for o in model.outputs(x)]
        pred = model.predict(x, torch.from_numpy(s["im_size"]).to(dtype)).float().numpy()
    return pred, maps


def test_gn_model_builds_with_the_jax_tree(mini_gn):
    model = PPYOLO.from_config(mini_gn["cfg"])
    sd = model.state_dict()
    assert set(sd) == set(mini_gn["flat"])
    gn_keys = [k for k in sd if ".gn." in k]
    assert gn_keys and not any(".bn." in k for k in sd)
    # the bridge both ways, bitwise
    sd = jax_params_to_state_dict(mini_gn["flat"], model)
    back = state_dict_to_jax_params(sd)
    assert set(back) == set(mini_gn["flat"])
    for k, v in mini_gn["flat"].items():
        assert np.array_equal(back[k], v), k


def test_gn_fp64_matches_jax_x64(mini_gn):
    jpred, jmaps = _exact(mini_gn)
    pred, maps = _port_run(_port(mini_gn, torch.float64), mini_gn, torch.float64)
    for m, jmap in zip(maps, jmaps):
        assert m.shape == jmap.shape
        np.testing.assert_allclose(m, jmap, rtol=1e-4, atol=1e-4)
    assert (pred[..., 0] >= 0).any()
    np.testing.assert_array_equal(pred[..., 0], jpred[..., 0])
    np.testing.assert_allclose(pred[..., 1:], jpred[..., 1:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["off", "inner", "on"])
def test_gn_bf16_gap_is_jax_gap(mini_gn, mode):
    """bf16 serving (GN has nothing to fold): each level's gap to the exact
    forward at most 1.1x JAX's in the same head mode."""
    _, exact = _exact(mini_gn)
    jp = jax_optimize(_jax_tree(mini_gn["flat"], np.float32), precision="bf16", fold_bn=True)
    _, want = _jax_run(mini_gn, jp, mini_gn["images"].astype(jnp.bfloat16), mode)
    with head_decompose(mode):
        _, got = _port_run(_port(mini_gn, torch.bfloat16), mini_gn, torch.bfloat16)
    for level, (g, w, e) in enumerate(zip(got, want, exact)):
        assert rel_l2(g, e) <= 1.1 * rel_l2(w, e), (mode, level, rel_l2(g, e), rel_l2(w, e))


def test_gn_train_step_matches_jax(mini_gn):
    s = mini_gn
    cfg = gn_cfg()
    batch = synthetic_batch(0, 2, SIZE, 2)
    state = jax_init_state(s["jm"], _jax_tree(s["flat"], np.float32), cfg)
    jstate, jlosses = jax.jit(jax_make_step(s["jm"], cfg))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    model = PPYOLO.from_config(cfg)
    model.load_state_dict(jax_params_to_state_dict(s["flat"], model))
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tstate = init_train_state(model, cfg)
    tstate, losses = make_train_step(model, cfg)(tstate, to_torch(batch))
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-3, err_msg=k)
    jparams = {k: np.asarray(v) for k, v in jax_flatten(jstate.params).items()}
    vel = tstate.velocity()
    sd = model.state_dict()
    assert set(vel) == set(jstate.velocity) and any(".gn." in k for k in vel)
    for k, jv in jstate.velocity.items():
        jv = np.asarray(jv)
        jv = hwio_to_oihw(jv) if jv.ndim == 4 else jv
        tol = 2e-3 if k.startswith("head.yolo_output_convs") else 0.2
        assert rel_l2(vel[k], jv) <= tol, k
        move = jparams[k]
        move = (hwio_to_oihw(move) if move.ndim == 4 else move) - p0[k].numpy()
        assert rel_l2(sd[k] - p0[k], move) <= tol, k


def test_gn_stem_declines_the_fused_kernel(mini_gn):
    """JAX's stem gate takes BN only (``stem_pallas.py:371``); the port's
    declines GN stems in bf16 eval, so a GN predict reaches DCN (K1's place)
    in stage 5 and never the fused stem (K2's)."""
    model = _port(mini_gn, torch.bfloat16)
    stem = [model.backbone.stage1_conv1_1, model.backbone.stage1_conv1_2,
            model.backbone.stage1_conv1_3]
    x = torch.zeros(1, 3, SIZE, SIZE, dtype=torch.bfloat16)
    assert not stem_eligible(stem, x)
    bn = PPYOLO.from_config(mini2x_cfg()).to(torch.bfloat16).eval()
    assert stem_eligible([bn.backbone.stage1_conv1_1, bn.backbone.stage1_conv1_2,
                          bn.backbone.stage1_conv1_3], x)
    with torch.no_grad():
        calls = kernel_flops(model.predict, torch.from_numpy(mini_gn["images"]).to(
            torch.bfloat16).permute(0, 3, 1, 2), torch.from_numpy(mini_gn["im_size"]))
    assert [n for n, _, _ in calls] == ["dcn_fwd", "dcn_fwd"]


def test_gn_fold_and_int8_skip_gn_layers_as_jax(mini_gn):
    """The BN fold and the int8 quantizer key on ``.bn.weight``
    (``ppyolo_tpu/eval/optimize.py:29-33,98``): a GN model's tree comes
    out of the fold unchanged and out of the quantizer with no int8 leaf,
    in both packages."""
    model = PPYOLO.from_config(mini_gn["cfg"])
    sd = jax_params_to_state_dict(mini_gn["flat"], model)
    folded = fold_bn_params(sd)
    assert set(folded) == set(sd) and all(torch.equal(folded[k], sd[k]) for k in sd)
    q = quantize_params_int8(sd)
    jq = jax_flatten(jax_quantize(jax_fold_bn(_jax_tree(mini_gn["flat"], np.float32))))
    assert sorted(q) == sorted(jq)
    assert not any(v.dtype == torch.int8 for v in q.values())


def test_gn_detector_serves_on_the_cpu(mini_gn):
    model = PPYOLO.from_config(mini_gn["cfg"])
    sd = jax_params_to_state_dict(mini_gn["flat"], model)
    det = Detector(model, sd, mini_gn["cfg"], target_size=SIZE, precision="bf16", device="cpu")
    images = (mini_gn["images"] * 255).astype(np.uint8)
    out = det.predict_batch(images, mini_gn["im_size"])
    assert out.shape == (2, 100, 6) and np.isfinite(out).all() and (out[..., 0] >= 0).any()
