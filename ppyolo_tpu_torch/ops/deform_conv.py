"""Modulated deformable convolution v2 (DCNv2), NCHW.

``deform_conv2d_plain`` is the gather formulation of
``ppyolo_tpu/ops/deform_conv.py:32-123`` line for line: sampling positions
``i*stride - padding + k + offset`` clamped to the padded field
``[-padding, H-1+padding]``, four bilinear corners with zeros outside the
true image, ``sigmoid(mask)`` modulation, then one
``[N*oH*oW, k2*C] x [k2*C, outC]`` product.  It is the CPU path (autograd
gives its gradient) and the oracle of the Hopper forward kernel K1
(``ops/deform_conv_cuda.py``).

On the card a DCN that needs a gradient runs as ``DeformConv2dFunction``,
the counterpart of the ``custom_vjp`` in
``ppyolo_tpu/ops/deform_conv_pallas.py::_make_dcn_fast``: K1 forward, and a
backward (``dcn_backward``) of two dense products (``dm = g @ W^T`` and
``dW = cols^T @ g``, which the JAX package too computes outside its kernel)
around K3, the per-(pixel, tap) part.  ``dcn_bwd_plain`` is K3's plain
version: it repeats the kernel's arithmetic, serves the CPU tests as the
oracle against the Pallas backward, and runs nowhere on the card's path.

Clamps follow ``jnp.clip``'s gradient (half of it exactly at a bound):
bf16 offsets do land exactly on ``H-1+padding`` at image edges.

Arithmetic runs in fp32 whatever x's dtype (fp64 for fp64 x): the
interpolated, modulated columns are rounded to x's dtype (bf16 in serving)
and multiplied by the weight rounded the same way, with an fp32 sum -- the
kernel's contract.  ``operand_dtype`` rounds x, the columns and the weight
to another dtype instead: bf16 is what the kernels do to an fp32 layer, so
an fp32 CPU run with it repeats the card's rounding.

``dcn_form`` (the JAX package's ``dcn_impl``) picks what ``deform_conv2d``
runs: ``auto`` as above; ``plain`` the plain version on any device (the
portable form of a serving artifact, as JAX exports its ``onehot`` DCN);
``kernel`` the ``ppyolo::dcn_fwd`` operator (``ops/deform_conv_cuda.py``),
which ``torch.export`` keeps as one node (K1 on a card).

Offsets arrive as the raw offset/mask conv output ``om`` [N, 3*k2, oH, oW]:
channels ``[0, 2*k2)`` are the (y, x) offset of each tap, interleaved per
tap in row-major tap order; channels ``[2*k2, 3*k2)`` are the mask logits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .module import make_contextvar_override

DCN_FORM, dcn_form = make_contextvar_override("DCN_FORM", ("auto", "plain", "kernel"), "auto")


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - (k - 1) - 1) // stride + 1


def needs_grad(*ts: torch.Tensor) -> bool:
    """Will autograd want a gradient through an op on these tensors?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, so a value exactly on a bound gets
    half the gradient (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(v, v.new_tensor(lo)), v.new_tensor(hi))


def _positions(om, H, W, kh, kw, stride, padding, acc):
    """Unclamped sampling positions (raw_y, raw_x) and mask logits, each
    [N,oH,oW,k2] in ``acc`` (``_corner_tables`` before its clip)."""
    N, _, oH, oW = om.shape
    k2 = kh * kw
    dev = om.device
    omh = om.permute(0, 2, 3, 1).to(acc)                        # [N,oH,oW,3k2]
    off = omh[..., :2 * k2].reshape(N, oH, oW, k2, 2)
    iy = torch.arange(oH, dtype=acc, device=dev) * stride - padding
    ix = torch.arange(oW, dtype=acc, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=acc, device=dev)
    kx = torch.arange(kw, dtype=acc, device=dev)
    base_y = (iy[:, None, None] + ky[None, :, None]).expand(oH, kh, kw).reshape(oH, k2)
    base_x = (ix[:, None, None] + kx[None, None, :]).expand(oW, kh, kw).reshape(oW, k2)
    raw_y = base_y[None, :, None, :] + off[..., 0]
    raw_x = base_x[None, None, :, :] + off[..., 1]
    return raw_y, raw_x, omh[..., 2 * k2:]


def _corners(pos_y, pos_x, H, W):
    """(bilinear weight, valid, flat index yi*W+xi) of the 4 corners, in
    _corner_tables' order; weights without the valid mask."""
    y0 = torch.floor(pos_y)
    x0 = torch.floor(pos_x)
    ly = pos_y - y0
    lx = pos_x - x0
    out = []
    for dy, dx, wc in ((0, 0, (1.0 - ly) * (1.0 - lx)), (0, 1, (1.0 - ly) * lx),
                       (1, 0, ly * (1.0 - lx)), (1, 1, ly * lx)):
        yc, xc = y0 + dy, x0 + dx
        valid = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
        idx = yc.clamp(0, H - 1).to(torch.int64) * W + xc.clamp(0, W - 1).to(torch.int64)
        out.append((wc, valid, idx))
    return out, ly, lx


def _gather(xf, idx, C, acc):
    """x rows [N, H*W, C] at idx [N,oH,oW,k2] -> [N,oH,oW,k2,C] in acc."""
    N = xf.shape[0]
    i = idx.reshape(N, -1, 1).expand(-1, -1, C)
    return torch.gather(xf, 1, i).reshape(*idx.shape, C).to(acc)


def deform_conv2d_plain(x: torch.Tensor, weight: torch.Tensor, om: torch.Tensor,
                        *, stride: int = 1, padding: int = 1,
                        bias: Optional[torch.Tensor] = None,
                        operand_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch DCNv2.  x [N,C,H,W]; weight [outC,C,kh,kw] (OIHW);
    om [N,3*kh*kw,oH,oW].  Returns [N,outC,oH,oW] in x's dtype,
    channels_last.  x, the columns and the weight are rounded to
    ``operand_dtype`` (default x's dtype)."""
    N, C, H, W = x.shape
    out_c, _, kh, kw = weight.shape
    oH, oW = out_size(H, kh, stride, padding), out_size(W, kw, stride, padding)
    k2 = kh * kw
    acc = torch.promote_types(x.dtype, torch.float32)
    op = x.dtype if operand_dtype is None else operand_dtype
    out_dtype = x.dtype
    x = x.to(op)

    raw_y, raw_x, mask = _positions(om, H, W, kh, kw, stride, padding, acc)
    pos_y = _clip(raw_y, -float(padding), float(H - 1 + padding))
    pos_x = _clip(raw_x, -float(padding), float(W - 1 + padding))
    xf = x.permute(0, 2, 3, 1).reshape(N, H * W, C)
    corners, _, _ = _corners(pos_y, pos_x, H, W)
    val = sum(wc[..., None] * (_gather(xf, idx, C, acc) * valid[..., None].to(acc))
              for wc, valid, idx in corners)                   # [N,oH,oW,k2,C]
    val = val * torch.sigmoid(mask)[..., None]

    # tap-major then channel: the (kh, kw, C) flatten of an HWIO kernel
    lhs = val.to(op).to(acc).reshape(N * oH * oW, k2 * C)
    rhs = weight.to(op).to(acc).permute(2, 3, 1, 0).reshape(k2 * C, out_c)
    out = (lhs @ rhs).to(out_dtype).reshape(N, oH, oW, out_c)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out.permute(0, 3, 1, 2)


def dcn_bwd_plain(x: torch.Tensor, om: torch.Tensor, dm: torch.Tensor, *,
                  ksize: Tuple[int, int], stride: int, padding: int):
    """Plain version of K3 (``csrc/dcn_bwd.cu``), same contract: x
    [N,C,H,W], om [N,3*k2,oH,oW], dm [N*oH*oW, k2*C] (``g @ W^T``, tap-major
    then channel).  Returns dx [N,C,H,W] in fp32 (fp64 for fp64 x),
    channels_last; d_om in om's dtype, channels_last; cols [N*oH*oW, k2*C]
    = sampled * sigmoid(mask) rounded to x's dtype (the forward's columns).
    Arithmetic in fp32 (fp64) from x's and dm's values, as the kernel."""
    N, C, H, W = x.shape
    kh, kw = ksize
    k2 = kh * kw
    oH, oW = out_size(H, kh, stride, padding), out_size(W, kw, stride, padding)
    acc = torch.promote_types(x.dtype, torch.float32)
    with torch.no_grad():
        raw_y, raw_x, mask = _positions(om, H, W, kh, kw, stride, padding, acc)
        lo, hy, hx = -float(padding), float(H - 1 + padding), float(W - 1 + padding)
        corners, ly, lx = _corners(raw_y.clamp(lo, hy), raw_x.clamp(lo, hx), H, W)
        xf = x.permute(0, 2, 3, 1).reshape(N, H * W, C)
        g = dm.reshape(N, oH, oW, k2, C).to(acc)
        m = torch.sigmoid(mask)
        xs = [_gather(xf, idx, C, acc) for _, _, idx in corners]
        sampled = sum((wc * valid)[..., None] * xv
                      for (wc, valid, _), xv in zip(corners, xs))
        dmod = (g * sampled).sum(-1)
        dsamp = g * m[..., None]
        cols = (sampled * m[..., None]).to(x.dtype).reshape(N * oH * oW, k2 * C)
        dx = torch.zeros(N * H * W, C, dtype=acc, device=x.device)
        base = (torch.arange(N, device=x.device) * (H * W)).view(N, 1, 1, 1)
        dw = []
        for (wc, valid, idx), xv in zip(corners, xs):
            dx.index_add_(0, (base + idx).reshape(-1),
                          ((wc * valid)[..., None] * dsamp).reshape(-1, C))
            dw.append((dsamp * xv).sum(-1) * valid)
        # vjp of _corner_tables: through the bilinear weights, then the clip
        dly = -(1 - lx) * dw[0] - lx * dw[1] + (1 - lx) * dw[2] + lx * dw[3]
        dlx = -(1 - ly) * dw[0] + (1 - ly) * dw[1] - ly * dw[2] + ly * dw[3]
        d_off = torch.stack([dly * _clip_grad(raw_y, lo, hy),
                             dlx * _clip_grad(raw_x, lo, hx)], -1)
        d_om = torch.cat([d_off.reshape(N, oH, oW, 2 * k2), dmod * m * (1 - m)], -1)
    cl = torch.channels_last
    return (dx.reshape(N, H, W, C).permute(0, 3, 1, 2),
            d_om.to(om.dtype).permute(0, 3, 1, 2).contiguous(memory_format=cl), cols)


def _clip_grad(v, lo, hi):
    """d jnp.clip(v, lo, hi) / dv: 1 inside, 1/2 on a bound, 0 outside."""
    inside = ((v > lo) & (v < hi)).to(v.dtype)
    return inside + 0.5 * ((v == lo) | (v == hi)).to(v.dtype)


def dcn_backward(x: torch.Tensor, weight: torch.Tensor, om: torch.Tensor,
                 g: torch.Tensor, *, stride: int, padding: int, plain: bool = False,
                 operand_dtype: Optional[torch.dtype] = None):
    """(dx, dweight, d_om) of ``deform_conv2d`` for the output gradient g
    [N,outC,oH,oW].  ``dm = g @ W^T`` and ``dW = cols^T @ g`` are the dense
    products of ``_dcn_bwd_pallas`` (lines 289-291, 337-339); between them
    runs K3 for a CUDA tensor, its plain version for a CPU tensor or with
    ``plain`` (the card's oracle).  On the card the operands are bf16 with
    fp32 sums, as K1's; on the CPU they keep x's dtype unless
    ``operand_dtype`` says otherwise."""
    N, C, H, W = x.shape
    out_c, _, kh, kw = weight.shape
    k2 = kh * kw
    if x.is_cuda:
        op = torch.bfloat16
    else:
        op = x.dtype if operand_dtype is None else operand_dtype
    w2 = weight.permute(2, 3, 1, 0).reshape(k2 * C, out_c).to(op)   # pack_dcn_weight(weight).t()
    gf = g.permute(0, 2, 3, 1).reshape(-1, out_c).to(op)
    dm = gf @ w2.t()                                             # [N*P, k2*C]
    xo = x.to(op).contiguous(memory_format=torch.channels_last)
    omc = om.contiguous(memory_format=torch.channels_last)
    if plain or not x.is_cuda:
        dx, d_om, cols = dcn_bwd_plain(xo, omc, dm, ksize=(kh, kw), stride=stride,
                                       padding=padding)
    else:
        from .deform_conv_cuda import dcn_bwd

        dx, d_om, cols = dcn_bwd(xo, omc, dm, ksize=(kh, kw), stride=stride,
                                 padding=padding)
    dw = (cols.t() @ gf).reshape(kh, kw, C, out_c).permute(3, 2, 0, 1)
    return dx.to(x.dtype), dw.to(weight.dtype), d_om.to(om.dtype)


def _dcn_forward(x, weight, om, stride, padding, operand_dtype):
    if not x.is_cuda:
        return deform_conv2d_plain(x, weight, om, stride=stride, padding=padding,
                                   operand_dtype=operand_dtype)
    from .deform_conv_cuda import dcn_fwd, pack_dcn_weight

    cl = torch.channels_last
    kh, kw = weight.shape[2:]
    return dcn_fwd(x.contiguous(memory_format=cl), om.contiguous(memory_format=cl),
                   pack_dcn_weight(weight), None, ksize=(kh, kw), stride=stride,
                   padding=padding)


class DeformConv2dFunction(torch.autograd.Function):
    """DCNv2 with a hand-written backward: K1 forward, ``dcn_backward``
    (K3 between two products) backward; the plain versions for CPU
    tensors, whose operands ``operand_dtype`` can round as the kernels do.
    Saves (x, weight, om); the weight is packed inside."""

    @staticmethod
    def forward(ctx, x, weight, om, stride: int, padding: int,
                operand_dtype: Optional[torch.dtype] = None):
        ctx.stride, ctx.padding, ctx.operand_dtype = stride, padding, operand_dtype
        ctx.save_for_backward(x, weight, om)
        return _dcn_forward(x, weight, om, stride, padding, operand_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, om = ctx.saved_tensors
        dx, dw, d_om = dcn_backward(x, weight, om, g, stride=ctx.stride,
                                    padding=ctx.padding, operand_dtype=ctx.operand_dtype)
        return dx, dw, d_om, None, None, None


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor, om: torch.Tensor, *,
                  stride: int = 1, padding: int = 1,
                  bias: Optional[torch.Tensor] = None,
                  packed_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DCNv2 on x's device.  A CPU tensor takes the plain version (autograd
    gives its gradient).  A CUDA tensor takes the Hopper kernels: through
    ``DeformConv2dFunction`` when a gradient is needed, else K1 alone with
    ``packed_weight`` (``pack_dcn_weight(weight)``, which a caller that
    serves the same weight many times computes once).  It raises if a
    kernel cannot launch.  ``dcn_form`` overrides the choice (module
    docstring)."""
    form = DCN_FORM.get()
    out = _deform_conv2d(x, weight, om, form, stride, padding, bias, packed_weight)
    if _build.recording():
        _note_calls(x, weight, out, stride, padding, launched=x.is_cuda and form != "plain")
    return out


def _note_calls(x, weight, out, stride, padding, launched: bool) -> None:
    """Report K1's call and, where a backward will run, K3's as it runs (a
    hook on the output; on the CPU autograd's backward of the plain version
    takes K3's place)."""
    from ..utils.mfu import dcn_bwd_flops, dcn_fwd_flops

    n, c, h, w = x.shape
    co, _, kh, kw = weight.shape
    shape = (n, out_size(h, kh, stride, padding), out_size(w, kw, stride, padding), kh * kw, c)
    _build.note_call("dcn_fwd", dcn_fwd_flops(*shape, co), launched)
    if out.requires_grad:
        out.register_hook(lambda g: _build.note_call("dcn_bwd", dcn_bwd_flops(*shape), launched))


def _deform_conv2d(x, weight, om, form, stride, padding, bias, packed_weight):
    if form == "kernel":
        from .deform_conv_cuda import pack_dcn_weight

        kh, kw = weight.shape[2:]
        packed = pack_dcn_weight(weight, torch.bfloat16 if x.is_cuda else x.dtype)
        return torch.ops.ppyolo.dcn_fwd(x, om, packed, bias, kh, kw, stride, padding)
    if x.device.type == "cpu" or form == "plain":
        return deform_conv2d_plain(x, weight, om, stride=stride,
                                   padding=padding, bias=bias)
    if needs_grad(x, weight, om):
        out = DeformConv2dFunction.apply(x, weight, om, stride, padding)
        return out if bias is None else out + bias.to(out.dtype)
    from .deform_conv_cuda import dcn_fwd, pack_dcn_weight

    if packed_weight is None:
        packed_weight = pack_dcn_weight(weight)
    kh, kw = weight.shape[2:]
    cl = torch.channels_last  # no copy when the producer already wrote NHWC
    return dcn_fwd(x.contiguous(memory_format=cl), om.contiguous(memory_format=cl),
                   packed_weight, bias, ksize=(kh, kw), stride=stride,
                   padding=padding)
