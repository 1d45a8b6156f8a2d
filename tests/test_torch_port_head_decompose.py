"""The head's virtual concat (``models/head.py::head_decompose``,
``ConvNormAct.forward_parts``) against the JAX package's ``HEAD_DECOMPOSE``
modes, on the CPU, on the mini-2x head (CoordConv, SPP, the route concat,
DCN in stage 5).

JAX sums its parts with ``preferred_element_type=jnp.float32``, which it
refuses for fp64 operands (``test_jax_parts_refuse_fp64``), so JAX's
``inner`` and ``on`` run only up to fp32: in fp64 every port mode is held
within 1e-9 of JAX's x64 ``off`` (the same function) and of the port's
own ``off``; in fp32 each port mode lies no farther from the exact forward
(relative L2) than twice JAX's same mode; in bf16 (BN folded, the serving form) each
mode's gap to the exact forward is at most 1.1x JAX's same-mode gap per
level (the yardstick of ``test_bf16_gap_to_jax_is_rounding_order``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.eval.optimize import optimize_for_inference as jax_optimize
from ppyolo_tpu.models import PPYOLO as JaxPPYOLO
from ppyolo_tpu.models.head import head_decompose as jax_head_decompose
from ppyolo_tpu.ops.module import Ctx, unflatten_tree as jax_unflatten

from ppyolo_tpu_torch.checkpoint.bridge import state_dict_to_jax_params
from ppyolo_tpu_torch.eval.optimize import optimize_for_inference
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.models.head import decompose_mode, head_decompose
from ppyolo_tpu_torch.ops.conv import ConvNormAct, match_int8_form, recording

from test_torch_port_train import mini2x_cfg

MODES = ["off", "inner", "on"]
SIZE = 96


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _setup():
    """The mini-2x model with seeded weights, non-trivial BN statistics and
    offset convs that make every DCN sample off the grid; its JAX tree."""
    cfg = mini2x_cfg()
    model = PPYOLO.from_config(cfg).init_parameters(torch.Generator().manual_seed(4))
    sd = model.state_dict()
    r = np.random.RandomState(5)
    for k in sorted(sd):
        if "conv_offset" in k:
            sd[k] = torch.from_numpy((r.randn(*sd[k].shape) * 0.02).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(r.uniform(0.5, 2.0, sd[k].shape).astype(np.float32))
        elif k.endswith("running_mean") or k.endswith("bn.bias"):
            sd[k] = torch.from_numpy((r.randn(*sd[k].shape) * 0.1).astype(np.float32))
    model.load_state_dict(sd)
    images = np.random.RandomState(6).rand(2, SIZE, SIZE, 3).astype(np.float32)
    flat = state_dict_to_jax_params(sd)
    return cfg, sd, images, JaxPPYOLO.from_config(cfg), flat


def _port_maps(cfg, sd, images, mode, dtype, fold=False):
    model = PPYOLO.from_config(cfg)
    if fold:
        sd = optimize_for_inference(sd, precision="bf16", fold_bn=True)
    model = model.to(dtype, memory_format=torch.channels_last)
    model.load_state_dict(sd)
    x = torch.from_numpy(images).to(dtype).permute(0, 3, 1, 2)
    with torch.no_grad(), head_decompose(mode):
        outs = model.outputs(x)
    return [o.double().permute(0, 2, 3, 1).numpy() for o in outs]


def _jax_maps(jmodel, flat, images, mode, dtype):
    def maps(p, x):
        ctx = Ctx(train=False)
        return jmodel.head.get_outputs(p["head"], jmodel.features(p, x, ctx), ctx)

    params = jax_unflatten({k: jnp.asarray(np.asarray(v, dtype)) for k, v in flat.items()})
    with jax_head_decompose(mode):
        outs = jax.jit(maps)(params, jnp.asarray(images.astype(dtype)))
    return [np.asarray(o).astype(np.float64) for o in outs]


def _exact(setup):
    cfg, sd, images, jmodel, flat = setup
    with jax.enable_x64(True):
        return _jax_maps(jmodel, flat, images, "off", np.float64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _err(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def test_jax_parts_refuse_fp64(setup):
    """Why JAX's inner/on are compared in fp32 and bf16 only."""
    cfg, sd, images, jmodel, flat = setup
    with jax.enable_x64(True), pytest.raises(TypeError, match="narrower"):
        _jax_maps(jmodel, flat, images, "inner", np.float64)


@pytest.mark.parametrize("mode", MODES)
def test_fp64_modes_match_jax_x64(setup, mode):
    cfg, sd, images, _, _ = setup
    exact = _exact(setup)
    got = _port_maps(cfg, sd, images, mode, torch.float64)
    off = _port_maps(cfg, sd, images, "off", torch.float64)
    assert [g.shape for g in got] == [e.shape for e in exact]
    assert _err(got, exact) <= 1e-9
    assert _err(got, off) <= 1e-9


@pytest.mark.parametrize("mode", MODES)
def test_fp32_modes_match_jax_same_mode(setup, mode):
    cfg, sd, images, jmodel, flat = setup
    exact = _exact(setup)
    got = _port_maps(cfg, sd, images, mode, torch.float32)
    want = _jax_maps(jmodel, flat, images, mode, np.float32)
    for level, (g, w, e) in enumerate(zip(got, want, exact)):
        # measured 1.6-1.9 in every mode, off included: the CPU convs' fp32
        # sums, not the parts
        assert _rel(g, e) <= 2 * _rel(w, e), (mode, level, _rel(g, e), _rel(w, e))


@pytest.mark.parametrize("mode", MODES)
def test_bf16_gap_per_mode_is_jax_same_mode_gap(setup, mode):
    """Folded bf16 (the serving form) against the exact forward: the port's
    gap per level at most 1.1x JAX's in the same mode."""
    cfg, sd, images, jmodel, flat = setup
    exact = _exact(setup)
    got = _port_maps(cfg, sd, images, mode, torch.bfloat16, fold=True)
    jflat = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    jp = jax_optimize(jax_unflatten({k: jnp.asarray(v) for k, v in jflat.items()}),
                      precision="bf16", fold_bn=True)

    def maps(p, x):
        ctx = Ctx(train=False)
        return jmodel.head.get_outputs(p["head"], jmodel.features(p, x, ctx), ctx)

    with jax_head_decompose(mode):
        want = [np.asarray(o).astype(np.float64) for o in
                jax.jit(maps)(jp, jnp.asarray(images.astype(jnp.bfloat16)))]
    for level, (g, w, e) in enumerate(zip(got, want, exact)):
        print(f"{mode} level {level}: port {_rel(g, e):.3e} jax {_rel(w, e):.3e}")
        assert _rel(g, e) <= 1.1 * _rel(w, e), (mode, level, _rel(g, e), _rel(w, e))


def test_auto_mode_resolves_as_jax():
    assert decompose_mode(True, torch.bfloat16) == "off"
    assert decompose_mode(False, torch.float32) == "off"
    assert decompose_mode(False, torch.bfloat16) in ("off", "inner", "on")
    with head_decompose("on"):
        assert decompose_mode(True, torch.float32) == "on"
    with pytest.raises(ValueError):
        head_decompose("sideways")


def test_calibration_records_the_same_amaxes_under_inner(setup):
    """The int8 calibration (``calibrate_act_scales`` records under
    ``recording()`` through the int8 model, whose head convs take the
    materialized concat) records bitwise the same amaxes under ``inner``
    as under ``off``; a dense bf16 conv's parts record the concat's amax."""
    cfg, sd, images, _, _ = setup
    model = PPYOLO.from_config(cfg)
    sd8 = optimize_for_inference(sd, precision="int8", fold_bn=True)
    match_int8_form(model, sd8)
    model = model.to(torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(sd8)
    x = torch.from_numpy(images).to(torch.bfloat16).permute(0, 3, 1, 2)
    recs = {}
    for mode in ("off", "inner"):
        with torch.no_grad(), head_decompose(mode), recording() as rec:
            model.outputs(x)
        recs[mode] = rec
    assert set(recs["off"]) == set(recs["inner"]) and len(recs["off"]) > 0
    for m, v in recs["off"].items():
        assert torch.equal(recs["inner"][m], v)

    conv = ConvNormAct(20, 8, 1, norm="bn", act="leaky").eval().to(torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    a = torch.randn(2, 12, 5, 5, generator=g).bfloat16()
    b = (torch.randn(2, 8, 5, 5, generator=g) * 3).bfloat16()
    with torch.no_grad(), recording() as parts:
        conv.forward_parts([a, b])
    with torch.no_grad(), recording() as whole:
        conv(torch.cat([a, b], dim=1))
    assert torch.equal(parts[conv], whole[conv])


def test_int8_and_dcn_take_the_materialized_concat(setup):
    cfg, sd, images, _, _ = setup
    model = PPYOLO.from_config(cfg)
    sd8 = optimize_for_inference(sd, precision="int8", fold_bn=True)
    match_int8_form(model, sd8)
    model = model.to(torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(sd8)
    x = torch.from_numpy(images).to(torch.bfloat16).permute(0, 3, 1, 2)
    outs = {}
    for mode in MODES:
        with torch.no_grad(), head_decompose(mode):
            outs[mode] = model.outputs(x)
    for mode in ("inner", "on"):
        for a, b in zip(outs[mode], outs["off"]):
            assert torch.equal(a, b), mode

    dcn = ConvNormAct(40, 32, 3, norm="bn", act="relu", use_dcn=True)
    dcn.init_parameters(torch.Generator().manual_seed(0))
    dcn.eval()
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 24, 9, 9, generator=g), torch.randn(1, 16, 9, 9, generator=g)
    with torch.no_grad():
        want = dcn(torch.cat([a, b.expand(2, -1, -1, -1)], dim=1))
        assert torch.equal(dcn.forward_parts([a, b], coord=True), want)


def test_coordinate_term_follows_the_weight():
    """The kept coordinate term is recomputed when the weight changes, in
    place (``refresh_cache``), and equals the term of an uncached forward."""
    from ppyolo_tpu_torch.ops.blocks import coord_planes

    m = ConvNormAct(10, 8, 3, norm="bn", act="leaky").eval()
    m.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 7, 7, generator=torch.Generator().manual_seed(1))
    planes = coord_planes(7, 7, x.dtype, x.device)
    with torch.no_grad():
        first = m.forward_parts([x, planes], coord=True)
        kept = next(iter(m._coord_terms.values()))
        m.conv.weight.mul_(0.5)
        m.refresh_cache()
        assert next(iter(m._coord_terms.values())) is kept
        second = m.forward_parts([x, planes], coord=True)
        want = m.forward_parts([x, planes])          # no kept term
    assert not torch.equal(first, second)
    assert torch.equal(second, want)
