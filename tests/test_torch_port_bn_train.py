"""K7 (train-mode BatchNorm with its activation, ``ops/bn_train.py``) on
the CPU: its closed form in torch (``bn_train_plain_*``) against autograd of
``BatchNorm._forward_train`` then ``apply_act`` in fp64, the launch plan, the
ctypes signatures, and the CPU path's dispatch.  The kernels themselves run
on the card: ``tests/test_torch_port_gpu.py -k bn_train``."""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from ppyolo_tpu_torch.ops import bn_train as bt
from ppyolo_tpu_torch.ops.conv import ConvNormAct, apply_act
from ppyolo_tpu_torch.ops.module import BN_EPS, BN_MOMENTUM, BatchNorm, _recomputing

BIG = 2.0 ** 27   # x = BIG + k/2: E[x^2] - m^2 rounds to 0 or below in fp64


def _x(seed, n=2, c=4, h=3, w=4, special=True):
    """fp64 [n, c, h, w]; with ``special`` channel 1 is a tie (E[x²] - m²
    == 0 exactly) and channel 2 clamped (< 0), both with spread values."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g, dtype=torch.float64) * 1.7 + 0.3
    if special:
        for ch, s in ((1, 0), (2, 2)):
            gs = torch.Generator().manual_seed(s)
            x[:, ch] = BIG + torch.randint(-2, 3, (n, 1, h, w), generator=gs,
                                           dtype=torch.float64)[:, 0] * 0.5
    return x


def _params(seed, c):
    g = torch.Generator().manual_seed(seed + 100)
    f = dict(generator=g, dtype=torch.float64)
    return (torch.randn(c, **f) * 0.5 + 1.0, torch.randn(c, **f) * 0.3,
            torch.randn(c, **f) * 0.2, torch.rand(c, **f) + 0.5)


def _autograd(x, dy, act, params):
    """y, dx, dweight, dbias and the running statistics of the plain path."""
    w, b, rm, rv = params
    bn = BatchNorm(x.shape[1]).double().train()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
            t.copy_(v)
    xg = x.clone().requires_grad_(True)
    y = apply_act(bn(xg), act)
    y.backward(dy)
    return y.detach(), xg.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var


def _close(got, want, rtol=1e-9):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_plain_closed_form_matches_autograd_of_forward_train(act):
    """In fp64 the kernels' closed form (statistics from [Σx, Σx²], the
    clamp, y, the running update; dx from the two gradient sums with the
    clamp's factor, dweight, dbias) equals autograd of ``_forward_train``
    then the activation, channel by channel: a plain one, a tie (the
    gradient through v halved) and a clamped one (dropped), where the
    factor decides dx."""
    x = _x(0)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    m, msq = x.mean((0, 2, 3)), x.square().mean((0, 2, 3))
    d = msq - m.square()
    assert d[1] == 0 and d[2] < 0 and d[0] > 0 and d[3] > 0
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    params = _params(0, x.shape[1])
    y_w, dx_w, dw_w, db_w, rm_w, rv_w = _autograd(x, dy, act, params)
    w, b, rm, rv = (t.clone() for t in params)
    sums = bt.bn_train_plain_stats(x)
    assert torch.equal(sums, torch.cat([x.sum((0, 2, 3)), x.square().sum((0, 2, 3))]))
    y = bt.bn_train_plain_fwd(x, sums, n, w, b, rm, rv, act, update=True, eps=BN_EPS,
                              momentum=BN_MOMENTUM)
    dx, dw, db, own = bt.bn_train_plain_bwd(dy, x, sums, n, w, b, act, eps=BN_EPS)
    for got, want in ((dw, dw_w), (db, db_w), (rm, rm_w), (rv, rv_w)):
        _close(got, want)
    # autograd's route through E[x] and E[x²] cancels terms of |x| ~ 1.3e8
    # in the tied and clamped channels (2.7e8 times the spread |x - m|):
    # there it holds to 1e-6 of the channel's largest value, elsewhere 1e-9
    for ch, rtol in enumerate((1e-9, 1e-6, 1e-6, 1e-9)):
        _close(y[:, ch], y_w[:, ch], rtol)
        _close(dx[:, ch], dx_w[:, ch], rtol)
    # the factor matters: dx of the tied and clamped channels moves with it
    _, _, d_, invstd, _ = bt._plain_coeffs(sums, n, w, BN_EPS)
    xm = x - (sums[:4] / n).view(1, -1, 1, 1)
    term = (xm * (own[4:] * w * invstd ** 3 / n).view(1, -1, 1, 1)).abs().amax((0, 2, 3))
    assert term[1] > 1e3 * dx_w[:, 0].abs().max() and term[2] > 1e3 * dx_w[:, 0].abs().max()


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_plain_closed_form_counts_n_times_world(act):
    """Sync-BN's arithmetic: two halves of a batch, each with its own [Σx,
    Σx²] added to the other's (the all-reduce) over n × 2 values, give the
    whole batch's y and running statistics (unbiased over n × 2); the
    halves' gradient sums added give the whole batch's dx, and their own
    dweight and dbias add up to the whole batch's (the gradient bucket)."""
    x = _x(1, n=4, c=6, special=False)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    params = _params(1, x.shape[1])
    y_w, dx_w, dw_w, db_w, rm_w, rv_w = _autograd(x, dy, act, params)
    halves, dys = x.split(2), dy.split(2)
    n = 2 * halves[0].shape[0] * x.shape[2] * x.shape[3]
    sums = sum(bt.bn_train_plain_stats(h) for h in halves)
    w, b, rm, rv = (t.clone() for t in params)
    ys = [bt.bn_train_plain_fwd(h, sums, n, w, b, rm, rv, act, update=i == 0, eps=BN_EPS,
                                momentum=BN_MOMENTUM) for i, h in enumerate(halves)]
    own = [bt.bn_train_plain_bwd(g, h, sums, n, w, b, act, eps=BN_EPS)[3]
           for g, h in zip(dys, halves)]
    outs = [bt.bn_train_plain_bwd(g, h, sums, n, w, b, act, eps=BN_EPS, gsums=own[0] + own[1])
            for g, h in zip(dys, halves)]
    _close(torch.cat(ys), y_w)
    _close(torch.cat([o[0] for o in outs]), dx_w)
    _close(outs[0][1] + outs[1][1], dw_w)
    _close(outs[0][2] + outs[1][2], db_w)
    _close(rm, rm_w)
    _close(rv, rv_w)


def test_plain_forward_under_recompute_leaves_running_statistics():
    x = _x(2, special=False)
    w, b, rm, rv = _params(2, x.shape[1])
    before = (rm.clone(), rv.clone())
    n = x.shape[0] * x.shape[2] * x.shape[3]
    bt.bn_train_plain_fwd(x, bt.bn_train_plain_stats(x), n, w, b, rm, rv, "relu",
                          update=False, eps=BN_EPS, momentum=BN_MOMENTUM)
    assert torch.equal(rm, before[0]) and torch.equal(rv, before[1])


@pytest.mark.parametrize("act", [None, "relu", "leaky", "mish"])
@pytest.mark.parametrize("sync", [False, True])
def test_train_bn_on_a_cpu_tensor_never_calls_a_wrapper(act, sync):
    """A ConvNormAct in training on a CPU tensor takes ``_forward_train``
    (forward, backward, and a recompute under remat's flag): no K7 wrapper
    is called, and the result is the plain path's."""
    fns = (bt.bn_train_fwd, bt.bn_train_bwd)
    before = [(f.launches, f.captured) for f in fns]
    layer = ConvNormAct(8, 16, 3, act=act, norm="sync_bn" if sync else "bn").train()
    layer.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(1), requires_grad=True)
    y = layer(x)
    y.sum().backward()
    with _recomputing():
        layer(x.detach())
    want = apply_act(layer.bn._forward_train(torch.nn.functional.conv2d(
        x.detach(), layer.conv.weight, layer.conv.bias, 1, 1)), act).detach()
    assert [(f.launches, f.captured) for f in fns] == before
    assert x.grad is not None and torch.isfinite(x.grad).all()
    _close(y.detach(), want, 1e-6)


def test_batchnorm_refuses_an_activation_off_the_kernel_path():
    bn = BatchNorm(4).train()
    with pytest.raises(ValueError, match="train kernels"):
        bn(torch.zeros(1, 4, 2, 2), "relu")
    with pytest.raises(ValueError, match="not one of"):
        bt.bn_train(torch.zeros(1, 4, 2, 2), *(torch.zeros(4),) * 4, act="mish", update=True,
                    sync=False, eps=BN_EPS, momentum=BN_MOMENTUM)


# ppyolo_2x's BN widths at b8@608, with edges
@pytest.mark.parametrize("rows,c", [(8 * 304 * 304, 32), (8 * 152 * 152, 256),
                                    (8 * 19 * 19, 2048), (8 * 38 * 38, 512), (8 * 76 * 76, 128),
                                    (1, 8), (7, 48), (3, 1000), (100003, 24), (5, 3)])
@pytest.mark.parametrize("vec", [8, 4, 1])
@pytest.mark.parametrize("sms", [132, 114])
def test_launch_plan_covers_every_row_and_channel_once(rows, c, vec, sms):
    """Spans cover the channels (the kernels' tc = min(C / vec, 32)), row
    blocks the rows with none empty, one wave of BLOCKS_PER_SM blocks an
    SM at most (one a span where the spans are more), and a block's span
    fits the kernels' 256-channel shared memory."""
    vec = vec if c % vec == 0 else 1   # as the wrappers choose
    spans, row_blocks, rpb = bt.geometry(rows, c, vec, sms)
    tc = min(c // vec, bt.MAX_TC)
    assert tc * vec <= 256
    assert (spans - 1) * tc * vec < c <= spans * tc * vec
    assert (row_blocks - 1) * rpb < rows <= row_blocks * rpb
    assert row_blocks * spans <= max(bt.BLOCKS_PER_SM * sms, spans)
    tr = bt.THREADS // tc
    assert rpb >= min(tr, rows)


def test_launch_argtypes_match_the_c_signatures():
    """Each launch's ctypes argtypes follow its extern "C" signature in
    csrc/bn_train.cu (a pointer per pointer, an int per int, a float per
    float): ctypes checks nothing, and a mismatch shows only on the card."""
    src = (Path(bt.__file__).parents[1] / "csrc" / "bn_train.cu").read_text()
    for name, got in bt._ARGTYPES.items():
        sig = re.search(r'extern "C" int %s_launch\((.*?)\)' % name, src, re.S).group(1)
        want = []
        for p in sig.split(","):
            kind = p.split()[0]
            assert "*" in p or kind in ("int", "float"), p
            want.append(ctypes.c_void_p if "*" in p else
                        ctypes.c_int if kind == "int" else ctypes.c_float)
        assert got == want, name
    assert set(bt._ARGTYPES) == set(re.findall(r'extern "C" int (\w+)_launch', src))
