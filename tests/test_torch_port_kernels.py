"""The port's kernel modules against the JAX package, on the CPU.

The plain DCNv2 and the plain fused stem (the CPU paths and the oracles of
the Hopper kernels) are held against the JAX functions at fp32 (1e-4), and
against the Pallas kernels in interpret mode at bf16 tolerance.  Inputs are
made with numpy from a seed and handed to both.  The kernel-vs-plain tests
need a card and live in ``test_torch_port_gpu.py``.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppyolo_tpu.ops.deform_conv import deform_conv2d as jax_dcn
from ppyolo_tpu.ops.deform_conv_pallas import deform_conv2d_pallas
from ppyolo_tpu.ops.stem_pallas import fused_stem as jax_fused_stem
from ppyolo_tpu.ops.stem_pallas import fused_stem_reference

from ppyolo_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_plain
from ppyolo_tpu_torch.ops.stem import (apply_stem, fold_eval_bn, fused_stem, fused_stem_plain,
                                       pack_stem_params, stem_eligible, stem_params)


def nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW torch in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def oihw(w_hwio: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).to(dtype)


def _dcn_inputs(seed, n, h, w, c, oc, stride, off_scale=2.0):
    """x, HWIO weight, offsets (a few pixels, some far out of range) and
    mask logits, NHWC numpy."""
    r = np.random.RandomState(seed)
    oh = (h + 2 - 2 - 1) // stride + 1
    ow = (w + 2 - 2 - 1) // stride + 1
    x = r.randn(n, h, w, c).astype(np.float32)
    wt = (r.randn(3, 3, c, oc) * 0.1).astype(np.float32)
    off = (r.randn(n, oh, ow, 18) * off_scale).astype(np.float32)
    # out-of-range taps and offsets that land exactly on the clamp edges
    off[..., 0, 0, 0] = 3.0 * h
    off[..., 0, 0, 1] = -3.0 * w
    off[..., -1, -1, 2] = float(h)
    off[..., 1, :, 3] = -1.0
    msk = r.randn(n, oh, ow, 9).astype(np.float32)
    return x, wt, off, msk


def _om(off, msk, dtype=torch.float32):
    return nchw(np.concatenate([off, msk], axis=-1), dtype)


@pytest.mark.parametrize("shape", [(2, 9, 9, 8, 16, 1), (1, 10, 11, 8, 12, 2),
                                   (1, 7, 7, 4, 8, 2)])
def test_plain_dcn_matches_jax_fp32(shape):
    n, h, w, c, oc, stride = shape
    x, wt, off, msk = _dcn_inputs(sum(shape), n, h, w, c, oc, stride)
    dcn = jax.jit(functools.partial(jax_dcn, stride=stride, padding=1))
    want = np.asarray(dcn(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(off),
                          jnp.asarray(msk)))
    got = deform_conv2d_plain(nchw(x), oihw(wt), _om(off, msk), stride=stride,
                              padding=1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_packed_dcn_weight_is_the_k_major_hwio_flatten():
    """K1's weight: K-major [outC, k2*C] bf16 whose column tap*C + c is the
    JAX HWIO kernel's row (its [k2*C, outC] flatten, transposed), i.e. the
    transpose of the dm product's operand in dcn_backward."""
    from ppyolo_tpu_torch.ops.deform_conv_cuda import pack_dcn_weight

    _, wt, _, _ = _dcn_inputs(4, 1, 5, 5, 8, 16, 1)
    packed = pack_dcn_weight(oihw(wt))
    want = torch.from_numpy(np.ascontiguousarray(wt.reshape(9 * 8, 16).T)).to(torch.bfloat16)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(packed, want)


def test_dcn_dispatch_on_cpu_uses_plain():
    x, wt, off, msk = _dcn_inputs(5, 1, 6, 6, 4, 8, 1)
    bias = torch.linspace(-1, 1, 8)
    a = deform_conv2d(nchw(x), oihw(wt), _om(off, msk), stride=1, padding=1, bias=bias)
    b = deform_conv2d_plain(nchw(x), oihw(wt), _om(off, msk), stride=1, padding=1,
                            bias=bias)
    assert torch.equal(a, b)


def test_plain_dcn_matches_pallas_interpret_bf16():
    x, wt, off, msk = _dcn_inputs(11, 1, 9, 9, 8, 16, 1, off_scale=1.5)
    xb = x.astype(jnp.bfloat16)
    want = np.asarray(deform_conv2d_pallas(
        jnp.asarray(xb), jnp.asarray(wt), jnp.asarray(off), jnp.asarray(msk),
        stride=1, padding=1, interpret=True), np.float32)
    got = deform_conv2d_plain(nchw(x, torch.bfloat16), oihw(wt), _om(off, msk),
                              stride=1, padding=1)
    assert got.dtype == torch.bfloat16
    # bf16 operands (the Pallas kernel also rounds the corner weights to bf16)
    scale = np.abs(want).max()
    assert np.abs(nhwc(got) - want).max() <= 0.02 * scale


def _stem_weights(seed):
    r = np.random.RandomState(seed)
    w1 = (r.randn(3, 3, 3, 32) * 0.3).astype(np.float32)
    b1 = (r.randn(32) * 0.1).astype(np.float32)
    w2 = (r.randn(3, 3, 32, 32) * 0.1).astype(np.float32)
    b2 = (r.randn(32) * 0.1).astype(np.float32)
    w3 = (r.randn(3, 3, 32, 64) * 0.1).astype(np.float32)
    b3 = (r.randn(64) * 0.1).astype(np.float32)
    return w1, b1, w2, b2, w3, b3


def _torch_stem_args(ws, dtype):
    w1, b1, w2, b2, w3, b3 = ws
    return (oihw(w1, dtype), torch.from_numpy(b1), oihw(w2, dtype),
            torch.from_numpy(b2), oihw(w3, dtype), torch.from_numpy(b3))


@pytest.mark.parametrize("size,batch", [(32, 2), (40, 1), (27, 1)])
def test_plain_stem_matches_reference_fp32(size, batch):
    ws = _stem_weights(size)
    x = np.random.RandomState(1).randn(batch, size, size, 3).astype(np.float32)
    want = np.asarray(fused_stem_reference(jnp.asarray(x), *map(jnp.asarray, ws)))
    got = fused_stem_plain(nchw(x), *_torch_stem_args(ws, torch.float32))
    assert nhwc(got).shape == want.shape
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_plain_stem_matches_pallas_interpret_bf16():
    ws = _stem_weights(7)
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)
    jws = [jnp.asarray(w, jnp.bfloat16) if w.ndim == 4 else jnp.asarray(w)
           for w in ws]
    want = np.asarray(jax_fused_stem(jnp.asarray(x, jnp.bfloat16), *jws,
                                     interpret=True), np.float32)
    got = fused_stem(nchw(x, torch.bfloat16), *_torch_stem_args(ws, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and nhwc(got).shape == want.shape == (1, 16, 16, 64)
    # same arithmetic (bf16 operands, fp32 sums, bf16 between convs); sums
    # run in another order, so an element may round one bf16 ulp apart and
    # carry that into the next conv
    np.testing.assert_allclose(nhwc(got), want, rtol=0.02, atol=0.02)


def _stem_mods(seed):
    """The three eval-mode stem ConvNormActs with random weights and BN."""
    from ppyolo_tpu_torch.ops.conv import ConvNormAct

    mods = [ConvNormAct(3, 32, 3, stride=2, norm="bn", act="relu"),
            ConvNormAct(32, 32, 3, norm="bn", act="relu"),
            ConvNormAct(32, 64, 3, norm="bn", act="relu")]
    g = torch.Generator().manual_seed(seed)
    for m in mods:
        m.init_parameters(g)
        m.eval()
        with torch.no_grad():
            m.bn.running_mean.uniform_(-0.2, 0.2, generator=g)
            m.bn.running_var.uniform_(0.5, 1.5, generator=g)
            m.bn.weight.uniform_(0.5, 1.5, generator=g)
    return mods, g


def test_packed_stem_params_are_the_hwio_kernels_in_the_kernels_layout():
    """conv1_1 HWIO-flattened [27, 32] (bf16 values in fp32), conv1_2/1_3
    K-major [Co, 288] bf16 (column tap * 32 + ci), the biases in one fp32
    vector."""
    ws = _stem_weights(3)
    w1, w2, w3, bias = pack_stem_params(*_torch_stem_args(ws, torch.float32))
    bf = torch.bfloat16
    assert torch.equal(w1, torch.from_numpy(ws[0].reshape(27, 32)).to(bf).float())
    for got, hwio in ((w2, ws[2]), (w3, ws[4])):
        want = np.ascontiguousarray(hwio.reshape(288, -1).T)
        assert got.dtype == bf and got.is_contiguous()
        assert torch.equal(got, torch.from_numpy(want).to(bf))
    assert torch.equal(bias, torch.from_numpy(np.concatenate([ws[1], ws[3], ws[5]])))


def test_cached_stem_fold_is_the_per_call_path_and_follows_in_place_writes():
    """apply_stem folds BN and packs once per set of parameter values: the
    cached result is bit-identical to folding on every call, is reused while
    nothing changes, and is rebuilt after an in-place write."""
    mods, g = _stem_mods(1)
    x = torch.randn(2, 3, 40, 40, generator=g).to(torch.bfloat16)

    def per_call():
        ws = [t for m in mods for t in fold_eval_bn(m)]
        return fused_stem(x, *ws), pack_stem_params(*ws)

    want, want_packed = per_call()
    assert torch.equal(apply_stem(mods, x), want)
    folded, packed = stem_params(mods)
    assert all(torch.equal(a, b) for a, b in zip(packed, want_packed))
    assert stem_params(mods)[1] is packed and stem_params(mods)[0] is folded
    with torch.no_grad():
        mods[1].conv.weight.mul_(1.5)
        mods[2].bn.running_var.add_(0.5)
    new_want, new_packed = per_call()
    assert not torch.equal(new_want, want)
    assert torch.equal(apply_stem(mods, x), new_want)
    assert stem_params(mods)[1] is not packed
    assert all(torch.equal(a, b) for a, b in zip(stem_params(mods)[1], new_packed))


def test_stem_gate_and_bn_fold():
    mods, g = _stem_mods(0)
    xb = torch.zeros(1, 3, 32, 32, dtype=torch.bfloat16)
    assert stem_eligible(mods, xb)
    assert not stem_eligible(mods, xb.float())          # fp32 runs unfused
    mods[0].train()
    assert not stem_eligible(mods, xb)                  # so does training
    mods[0].eval()
    mods[2].act = "leaky"
    assert not stem_eligible(mods, xb)
    # folded conv + bias == conv -> eval BN, at fp32
    m = mods[1]
    x = torch.randn(1, 32, 8, 8, generator=g)
    w, b = fold_eval_bn(m)
    want = m.bn(torch.nn.functional.conv2d(x, m.conv.weight, padding=1))
    got = torch.nn.functional.conv2d(x, w, padding=1) + b.view(1, -1, 1, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
