"""The port's DCNv2 backward against the JAX package, on the CPU.

* ``dcn_backward`` with K3's plain version (``dcn_bwd_plain``) against the
  Pallas backward ``_dcn_bwd_pallas`` in interpret mode, at the shapes of
  ``tests/test_pallas_dcn.py``: 2% of each gradient's max-abs, the
  tolerance that file holds the Pallas kernel to (bf16 operands on both
  sides, summed in other orders).
* The port's DCN gradients -- autograd through ``deform_conv2d_plain`` (the
  CPU path) and the hand-written backward of ``DeformConv2dFunction`` (the
  card's path, here with the plain versions) -- against ``jax.vjp`` of
  ``ppyolo_tpu.ops.deform_conv.deform_conv2d`` in fp64 under
  ``jax.enable_x64``, with offsets exactly on the clamp bounds (where
  ``jnp.clip`` passes half the gradient): rtol = atol = 1e-9, i.e. the same
  arithmetic up to summation order.
* Through ``ConvNormAct``: x, the offset conv (om) and ``dcn_weight`` get
  their gradients, and the Function's equal autograd's.
Inputs are made with numpy from a seed and handed to both frameworks.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.ops.deform_conv import deform_conv2d as jax_dcn
from ppyolo_tpu.ops.deform_conv_pallas import _dcn_bwd_pallas

from ppyolo_tpu_torch.ops import deform_conv_cuda, stem, strided_conv
from ppyolo_tpu_torch.ops.conv import ConvNormAct
from ppyolo_tpu_torch.ops.deform_conv import (DeformConv2dFunction, dcn_backward,
                                              deform_conv2d, deform_conv2d_plain,
                                              needs_grad)


def nchw(a, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def oihw(w_hwio, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).to(dtype)


def _inputs(seed, n, h, w, c, oc, stride, off_scale=0.7, edges=True):
    """x, HWIO weight, offsets, mask logits and an output cotangent (NHWC).
    With ``edges``, some taps land exactly on the clamp bounds -padding and
    H-1+padding (and W's), and some far outside."""
    r = np.random.RandomState(seed)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = r.randn(n, h, w, c)
    wt = r.randn(3, 3, c, oc) * 0.1
    off = r.randn(n, oh, ow, 18) * off_scale
    msk = r.randn(n, oh, ow, 9)
    if edges:
        # tap 1 (ki=0, kj=1): base y = oh*stride - 1, base x = ow*stride
        off[:, :, :, 2] = np.where(np.arange(oh)[:, None] % 2, float(h), off[:, :, :, 2])
        off[:, 1, :, 2] = float(h) - stride + 1      # raw y = h = H-1+pad
        off[:, 0, :, 3] = -1.0 - np.arange(ow) * stride   # raw x = -1 = -pad
        off[:, :, 0, 8] = 3.0 * h                     # far below the image
        off[:, -1, -1, 17] = float(w) - (ow - 1) * stride - 1   # raw x = W = W-1+pad
    g = r.randn(n, oh, ow, oc)
    return x, wt, off, msk, g


@pytest.mark.parametrize("shape", [(2, 9, 9, 8, 16, 1), (1, 10, 10, 8, 12, 2)])
def test_plain_backward_matches_pallas_interpret(shape):
    n, h, w, c, oc, stride = shape
    x, wt, off, msk, g = _inputs(2, n, h, w, c, oc, stride, edges=False)
    f32 = [a.astype(np.float32) for a in (x, wt, off, msk, g)]
    want = _dcn_bwd_pallas(*map(jnp.asarray, f32), stride=stride, padding=1,
                           interpret=True)
    want = dict(zip(("x", "weight", "offset", "mask"), (np.asarray(a) for a in want)))
    om = nchw(np.concatenate([f32[2], f32[3]], -1), torch.float32)
    # the kernel's operand types: bf16 x (and so bf16 dm, cols, products)
    dx, dw, d_om = dcn_backward(nchw(f32[0], torch.bfloat16), oihw(f32[1], torch.float32),
                                om, nchw(f32[4], torch.float32), stride=stride, padding=1)
    got = {"x": nhwc(dx), "weight": dw.double().numpy().transpose(2, 3, 1, 0),
           "offset": nhwc(d_om)[..., :18], "mask": nhwc(d_om)[..., 18:]}
    for k, ref in want.items():
        assert got[k].shape == ref.shape, k
        assert np.abs(got[k] - ref).max() <= 0.02 * np.abs(ref).max(), k


@pytest.fixture(scope="module")
def jax_vjp_x64():
    """Memoised fp64 ``jax.vjp`` of the JAX gather DCN, keyed by shape."""
    memo = {}

    def run(shape):
        if shape not in memo:
            n, h, w, c, oc, stride = shape
            x, wt, off, msk, g = _inputs(sum(shape), n, h, w, c, oc, stride)
            with jax.enable_x64(True):
                fn = lambda *a: jax_dcn(*a, stride=stride, padding=1)
                out, vjp = jax.vjp(fn, *map(jnp.asarray, (x, wt, off, msk)))
                grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
            memo[shape] = ((x, wt, off, msk, g), np.asarray(out), grads)
        return memo[shape]

    return run


@pytest.mark.parametrize("path", ["autograd", "function"])
@pytest.mark.parametrize("shape", [(2, 7, 8, 8, 6, 1), (1, 9, 9, 4, 5, 2), (1, 3, 3, 8, 8, 1)])
def test_port_grads_match_jax_vjp_x64(jax_vjp_x64, shape, path):
    (x, wt, off, msk, g), jout, (jdx, jdw, joff, jmsk) = jax_vjp_x64(shape)
    stride = shape[-1]
    xt = nchw(x).requires_grad_()
    wtt = oihw(wt).requires_grad_()
    om = nchw(np.concatenate([off, msk], -1)).requires_grad_()
    if path == "autograd":
        out = deform_conv2d(xt, wtt, om, stride=stride, padding=1)
    else:
        out = DeformConv2dFunction.apply(xt, wtt, om, stride, 1)
    dx, dw, d_om = torch.autograd.grad(out, (xt, wtt, om), nchw(g))
    tol = dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(nhwc(out), jout, **tol)
    np.testing.assert_allclose(nhwc(dx), jdx, **tol)
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 1, 0), jdw, **tol)
    np.testing.assert_allclose(nhwc(d_om)[..., :18], joff, **tol)
    np.testing.assert_allclose(nhwc(d_om)[..., 18:], jmsk, **tol)


def test_edge_offsets_take_half_the_gradient():
    """A tap exactly on the bound -padding passes half of d/d(offset)
    (jnp.clip); torch.clamp would pass all of it.  Zero offsets put every
    first-row tap there (raw y = oh*stride - padding), as a freshly
    initialized offset conv does."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 3, 3, dtype=torch.float64, generator=gen)
    w = torch.randn(2, 4, 3, 3, dtype=torch.float64, generator=gen)

    def d_offset(off_y):
        om = torch.zeros(1, 27, 3, 3, dtype=torch.float64)
        om[0, 2, 0, 0] = off_y                  # tap 1 at (0, 0): raw y = -1 + off_y
        om.requires_grad_()
        deform_conv2d_plain(x, w, om, stride=1, padding=1)[0, :, 0, 0].sum().backward()
        return om.grad[0, 2, 0, 0].item()

    on_bound, inside = d_offset(0.0), d_offset(1e-7)
    assert inside != 0.0
    assert on_bound == pytest.approx(0.5 * inside, rel=1e-5)


def test_grads_reach_x_offsets_and_weight_through_conv_norm_act():
    """The repaired path: x, the offset conv and dcn_weight all get their
    gradients through a DCN ConvNormAct, and the hand-written backward of
    the card's Function gives the same ones as autograd (fp64)."""
    torch.manual_seed(0)
    m = ConvNormAct(8, 16, 3, stride=1, norm="bn", act="relu", use_dcn=True).double()
    m.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.conv.conv_offset.weight.normal_(0.0, 0.05)
        m.conv.conv_offset.bias.normal_(0.0, 0.5)
    m.train()
    x = torch.randn(2, 8, 7, 7, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 16, 7, 7, dtype=torch.float64)
    params = (m.conv.dcn_weight, m.conv.conv_offset.weight, m.conv.conv_offset.bias)
    grads = torch.autograd.grad(m(x), (x,) + params, g)
    for t in grads:
        assert t is not None and float(t.abs().max()) > 0.0
    # the same layer with the DCN run as the card's autograd.Function
    om = torch.nn.functional.conv2d(x, params[1], params[2], 1, 1)
    assert needs_grad(x, params[0], om)
    y = DeformConv2dFunction.apply(x, params[0], om, 1, 1)
    y = torch.relu(m.bn(y))
    for a, b in zip(torch.autograd.grad(y, (x,) + params, g), grads):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    with torch.no_grad():
        assert not needs_grad(x, params[0], om)


def _extern_c(name):
    """{function: parameter list} of the extern "C" functions of csrc/<name>.cu."""
    src = (Path(stem.__file__).parents[1] / "csrc" / f"{name}.cu").read_text()
    return {m.group(1): m.group(2)
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)', src, re.S)}


@pytest.mark.parametrize("name,nargs", [("dcn_fwd", 0), ("dcn_bwd", 1), ("fused_stem", 0),
                                        ("conv_s2", 0)])
def test_occupancy_exports_take_what_chip_smoke_passes(name, nargs):
    """Each library exports ``<name>*_blocks_per_sm``, which chip_smoke calls
    through ctypes with Python ints and no argtypes: only int parameters, as
    many as it passes (K3's names one of its two kernels).  The library
    exports nothing else besides its launch, and K3's the size of its dx
    pixels' bins (no parameters)."""
    fns = _extern_c(name)
    occ = [f for f in fns if f.endswith("_blocks_per_sm")]
    extra = {"dcn_bwd": {"dcn_bwd_bin_cap"}}.get(name, set())
    assert len(occ) == 1 and set(fns) == {occ[0], f"{name}_launch"} | extra
    for f in extra:
        assert fns[f].strip() in ("", "void")
    params = [p.strip() for p in fns[occ[0]].split(",") if p.strip()]
    assert len(params) == nargs and all(p.split()[0] == "int" for p in params)


def test_kernel_ab_earlier_dcn_interfaces():
    """kernel_ab binds the first K1 with today's C interface (only the
    weight's layout changed), the first K3 without the bins and entries
    (four pointers), and K3's binned and sorted forms with theirs."""
    from ppyolo_tpu_torch.tools import kernel_ab

    cur = deform_conv_cuda._ARGTYPES
    assert kernel_ab._EARLIER_ARGTYPES["dcn_fwd"] == cur["dcn_fwd"]
    forms = kernel_ab._EARLIER_DCN_BWD
    assert forms["first"] == cur["dcn_bwd"][:6] + cur["dcn_bwd"][10:]
    assert forms["binned"] == cur["dcn_bwd"][:9] + cur["dcn_bwd"][10:11] + cur["dcn_bwd"][10:]
    assert forms["sorted"] == cur["dcn_bwd"][:6] + [ctypes.c_void_p] * 6 + [ctypes.c_int] \
        + cur["dcn_bwd"][10:]
    with pytest.raises(ValueError, match="not a subset"):
        kernel_ab.main(["--earlier", ".", "--kernels", "dcn_fwd,dcn_bwd2"])


@pytest.mark.parametrize("name", ["dcn_fwd", "dcn_bwd", "fused_stem", "conv_s2"])
def test_launch_argtypes_match_the_c_signatures(name):
    """The ctypes argtypes of each kernel's wrapper follow its extern "C"
    signature in csrc/ (a pointer per pointer, an int per int): ctypes does
    not check them, and a mismatch shows only on the card."""
    src = (Path(stem.__file__).parents[1] / "csrc" / f"{name}.cu").read_text()
    sig = re.search(r'extern "C" int %s_launch\((.*?)\)' % name, src, re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in sig.split(",")]
    assert all("*" in p or p.split()[0] == "int" for p in sig.split(","))
    got = {"fused_stem": stem._ARGTYPES,
           "conv_s2": strided_conv._ARGTYPES}.get(name) or deform_conv_cuda._ARGTYPES[name]
    assert got == want
