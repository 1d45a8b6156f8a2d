"""Train-mode BatchNorm with its activation on the card: K7.

``csrc/bn_train.cu`` holds the kernels (the source's note says what bounds
them and what the design does about it).  ``bn_train_fwd`` runs the
statistics pass, the fixed-order reduce of its partials, sync-BN's
all-reduce of the ``[2C]`` sums where asked, and the normalize + affine +
activation pass, which also updates the running statistics in place;
``bn_train_bwd`` runs the gradient sums, their reduce (which writes dweight
and dbias), the all-reduce, and the dx pass.  Each wrapper is ``counted``
once a call (``_build.counted``), so a step of a model counts one forward
and one backward per BatchNorm layer.

``BatchNorm.forward`` (``ops/module.py``) takes this path for a CUDA tensor
in training; a CPU tensor keeps ``_forward_train``, the plain version the
CPU tests hold against the JAX package.  ``bn_train_plain_stats``,
``bn_train_plain_fwd`` and ``bn_train_plain_bwd`` are the kernels' closed
form written in torch: the tests hold them against autograd of
``_forward_train`` on the CPU and the kernels against ``_forward_train`` on
the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..parallel import dist

ACTS = {None: 0, "relu": 1, "leaky": 2}   # the activations the kernels apply
THREADS = 256            # a block of the data passes (csrc/bn_train.cu)
MAX_TC = 32              # 16-byte vectors of channels a block covers
# blocks a pass launches, per SM: one wave at two resident blocks an SM.  On
# the H100 a step's 76 layers took 5.89 ms at 264 blocks (132 SMs), 7.15 at
# 272, 7.67 at 1024 and 9.41 at 2048: a block's prologue and epilogue and a
# second wave's tail cost more than the loads they would overlap.
BLOCKS_PER_SM = 2
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "bn_train_fwd_stats": [_P, _P] + [_I] * 7 + [_P],
    "bn_train_reduce": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _F, _F, _P],
    "bn_train_fwd_apply": [_P] * 7 + [_I] * 8 + [_F] * 5 + [_I, _I, _P],
    "bn_train_bwd_stats": [_P] * 6 + [_I] * 8 + [_F, _F, _I, _P],
    "bn_train_bwd_dx": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load("bn_train"), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def geometry(rows: int, c: int, vec: int, sms: int) -> Tuple[int, int, int]:
    """(spans, row_blocks, rows_per_block) of a pass over ``[rows, c]``
    with ``vec`` channels a thread on a card of ``sms`` SMs: a span of
    min(c / vec, 32) vectors a block, and at most BLOCKS_PER_SM * sms
    blocks (one a span where the spans are more), each with at least one
    row a row thread."""
    tc = min(c // vec, MAX_TC)
    spans = -(-(c // vec) // tc)
    most = -(-rows // (THREADS // tc))
    row_blocks = max(1, min(most, BLOCKS_PER_SM * sms // spans))
    rows_per_block = -(-rows // row_blocks)
    return spans, -(-rows // rows_per_block), rows_per_block


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """Channels a thread loads at once: 16 bytes where every row starts on
    a 16-byte boundary, else one."""
    v = 16 // tensors[0].element_size()
    if c % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return v
    return 1


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x dtype {x.dtype} not supported (bf16 or fp32)")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be a channels_last [N, C, H, W] tensor")
    c = x.shape[1]
    for pname, p in (("weight", weight), ("bias", bias)):
        if p.dtype not in (torch.bfloat16, torch.float32) or p.dtype != weight.dtype:
            raise ValueError(f"{name}: {pname} dtype {p.dtype} (bf16 or fp32, as weight)")
        if tuple(p.shape) != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"{name}: {pname} must be a contiguous [{c}] on {x.device}")


@_build.counted
def bn_train_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 running_mean: torch.Tensor, running_var: torch.Tensor, *,
                 act: Optional[str], update: bool, eps: float, momentum: float,
                 all_reduce: Optional[Callable] = None,
                 world: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's forward on the card: ``act((x - m) * rsqrt(v + eps) * weight +
    bias)`` with the batch statistics, x [N, C, H, W] bf16 or fp32 in
    channels_last memory; ``update`` moves the running statistics (fp32
    [C], in place) by ``momentum`` toward the batch mean and unbiased
    variance.  ``all_reduce`` (sync-BN: ``torch.distributed.all_reduce``)
    sums the ``[2C]`` sums in place over ``world`` ranks between the two
    passes, and the statistics count N*H*W*world values.  Returns y (x's
    dtype, channels_last) and the sums ``[Σx, Σx²]`` the statistics came
    from (fp32 [2C], every rank's)."""
    _check("bn_train_fwd", x, weight, bias)
    for pname, t in (("running_mean", running_mean), ("running_var", running_var)):
        if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[1],) or not t.is_contiguous():
            raise ValueError(f"bn_train_fwd: {pname} must be a contiguous fp32 [{x.shape[1]}]")
    nb, c, h, w = x.shape
    rows = nb * h * w
    vec = _vec(c, x)
    spans, row_blocks, rpb = geometry(rows, c, vec, _sms(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((row_blocks, 2 * c), **f32)
    sums = torch.empty(2 * c, **f32)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    n = rows * world
    bf16, pbf16 = int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.note_launch(bn_train_fwd)
    _launch("bn_train_fwd_stats", x.data_ptr(), part.data_ptr(), bf16, rows, c, vec, spans,
            row_blocks, rpb, stream)
    _launch("bn_train_reduce", part.data_ptr(), sums.data_ptr(), row_blocks, 2 * c, None, None,
            None, 0, c, 0.0, 0.0, stream)
    if all_reduce is not None:
        all_reduce(sums)
    _launch("bn_train_fwd_apply", x.data_ptr(), sums.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(),
            bf16, pbf16, rows, c, vec, spans, row_blocks, rpb, float(n), eps,
            n / max(n - 1, 1), 1 - momentum, momentum, int(update), ACTS[act], stream)
    return y, sums


@_build.counted
def bn_train_bwd(dy: torch.Tensor, x: torch.Tensor, sums: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, *, act: Optional[str], eps: float,
                 all_reduce: Optional[Callable] = None, world: int = 1, need_dx: bool = True):
    """K7's backward on the card: (dx or None, dweight, dbias) of
    ``bn_train_fwd``'s output given its gradient ``dy`` (x's dtype and
    layout), from the forward's x and sums.  dweight and dbias are the
    rank's own (parameters' dtype); dx takes the gradient sums after
    ``all_reduce``, over every rank's N*H*W*world values."""
    _check("bn_train_bwd", x, weight, bias)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError("bn_train_bwd: dy must be a channels_last tensor like x")
    nb, c, h, w = x.shape
    if sums.dtype != torch.float32 or tuple(sums.shape) != (2 * c,):
        raise ValueError(f"bn_train_bwd: sums must be fp32 [{2 * c}]")
    rows = nb * h * w
    vec = _vec(c, x, dy)
    spans, row_blocks, rpb = geometry(rows, c, vec, _sms(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((row_blocks, 2 * c), **f32)
    gsums = torch.empty(2 * c, **f32)
    dweight, dbias = torch.empty_like(weight), torch.empty_like(bias)
    n = float(rows * world)
    bf16, pbf16 = int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.note_launch(bn_train_bwd)
    _launch("bn_train_bwd_stats", dy.data_ptr(), x.data_ptr(), sums.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), part.data_ptr(), bf16, pbf16, rows, c, vec,
            spans, row_blocks, rpb, n, eps, ACTS[act], stream)
    _launch("bn_train_reduce", part.data_ptr(), gsums.data_ptr(), row_blocks, 2 * c,
            sums.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), pbf16, c, n, eps, stream)
    if not need_dx:
        return None, dweight, dbias
    if all_reduce is not None:
        all_reduce(gsums)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    _launch("bn_train_bwd_dx", dy.data_ptr(), x.data_ptr(), sums.data_ptr(), gsums.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), bf16, pbf16, rows, c, vec,
            spans, row_blocks, rpb, n, eps, ACTS[act], stream)
    return dx, dweight, dbias


class _BNTrain(torch.autograd.Function):
    """K7 forward and backward as one autograd node; saves x (the layer's
    input, in its own dtype), the [2C] sums and the parameters."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, act, update, sync, eps,
                momentum):
        x = x.contiguous(memory_format=torch.channels_last)
        reduce_kw = (dict(all_reduce=torch.distributed.all_reduce, world=dist.world())
                     if sync else {})
        y, sums = bn_train_fwd(x, weight, bias, running_mean, running_var, act=act,
                               update=update, eps=eps, momentum=momentum, **reduce_kw)
        ctx.save_for_backward(x, sums, weight, bias)
        ctx.cfg = (act, eps, reduce_kw)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, sums, weight, bias = ctx.saved_tensors
        act, eps, reduce_kw = ctx.cfg
        dx, dweight, dbias = bn_train_bwd(
            dy.contiguous(memory_format=torch.channels_last), x, sums, weight, bias, act=act,
            eps=eps, need_dx=ctx.needs_input_grad[0], **reduce_kw)
        return (dx, dweight if ctx.needs_input_grad[1] else None,
                dbias if ctx.needs_input_grad[2] else None) + (None,) * 7


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor, *, act: Optional[str],
             update: bool, sync: bool, eps: float, momentum: float) -> torch.Tensor:
    """Train-mode BatchNorm and ``act`` (None, "relu" or "leaky") of a CUDA
    tensor through K7, differentiable in x, weight and bias; ``sync``
    all-reduces the statistics and the gradient sums over the process
    group."""
    if act not in ACTS:
        raise ValueError(f"bn_train: activation {act!r} is not one of {tuple(ACTS)}")
    return _BNTrain.apply(x, weight, bias, running_mean, running_var, act, update, sync, eps,
                          momentum)


def _act_plain(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "leaky":
        return F.leaky_relu(y, 0.1)
    return y


def _plain_coeffs(sums: torch.Tensor, n: int, weight: torch.Tensor, eps: float):
    """(m, v, d, rsqrt(v + eps), k) per channel from the [2C] sums."""
    c = sums.shape[0] // 2
    m, msq = sums[:c] / n, sums[c:] / n
    d = msq - m * m
    v = torch.clamp_min(d, 0.0)
    invstd = torch.rsqrt(v + eps)
    return m, v, d, invstd, invstd * weight.to(sums.dtype)


def bn_train_plain_stats(x: torch.Tensor) -> torch.Tensor:
    """K7's statistics in torch: ``[Σx, Σx²]`` over (N, H, W), fp32 for bf16
    and fp32 x, fp64 for fp64."""
    xa = x.to(torch.promote_types(x.dtype, torch.float32))
    return torch.cat([xa.sum((0, 2, 3)), xa.square().sum((0, 2, 3))])


def bn_train_plain_fwd(x: torch.Tensor, sums: torch.Tensor, n: int, weight: torch.Tensor,
                       bias: torch.Tensor, running_mean: torch.Tensor,
                       running_var: torch.Tensor, act: Optional[str], *, update: bool,
                       eps: float, momentum: float) -> torch.Tensor:
    """K7's forward in torch from the ``[2C]`` sums over ``n`` values (a
    rank's own, or every rank's added): y = (x - m) * k + bias rounded to
    x's dtype, then ``act``; the running statistics updated in place."""
    m, v, _, _, k = _plain_coeffs(sums, n, weight, eps)
    shape = (1, -1, 1, 1)
    y = ((x.to(sums.dtype) - m.view(shape)) * k.view(shape)
         + bias.to(sums.dtype).view(shape)).to(x.dtype)
    if update:
        with torch.no_grad():
            for buf, stat in ((running_mean, m), (running_var, v * (n / max(n - 1, 1)))):
                buf.copy_((1 - momentum) * buf + momentum * stat.to(buf.dtype))
    return _act_plain(y, act)


def bn_train_plain_bwd(dy: torch.Tensor, x: torch.Tensor, sums: torch.Tensor, n: int,
                       weight: torch.Tensor, bias: torch.Tensor, act: Optional[str], *,
                       eps: float, gsums: Optional[torch.Tensor] = None):
    """K7's backward in torch: (dx, dweight, dbias, the rank's own [Σg,
    Σg·(x - m)]) with g = dy * act'(y).  dweight and dbias come from the
    rank's sums, dx from ``gsums`` (every rank's, added) where given.  The
    gradient through v is dropped where E[x²] - m² < 0 and halved at a tie
    (``torch.maximum``'s rule)."""
    m, v, d, invstd, k = _plain_coeffs(sums, n, weight, eps)
    acc, shape = sums.dtype, (1, -1, 1, 1)
    xm = x.to(acc) - m.view(shape)
    y = (xm * k.view(shape) + bias.to(acc).view(shape)).to(x.dtype)
    g = dy
    if act == "relu":
        g = torch.where(y > 0, dy, torch.zeros_like(dy))
    elif act == "leaky":
        g = torch.where(y > 0, dy, dy * 0.1)
    g = g.to(acc)
    own = torch.cat([g.sum((0, 2, 3)), (g * xm).sum((0, 2, 3))])
    c = own.shape[0] // 2
    tot = own if gsums is None else gsums
    clamp = torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0)).to(acc)
    q = clamp * tot[c:] * weight.to(acc) * invstd ** 3 / n
    dx = k.view(shape) * (g - (tot[:c] / n).view(shape)) - xm * q.view(shape)
    return (dx.to(x.dtype), (own[c:] * invstd).to(weight.dtype), own[:c].to(bias.dtype), own)
