"""Modulated deformable convolution v2 (DCNv2), NCHW.

``deform_conv2d_plain`` is the gather formulation of
``ppyolo_tpu/ops/deform_conv.py:32-123`` line for line: sampling positions
``i*stride - padding + k + offset`` clamped to the padded field
``[-padding, H-1+padding]``, four bilinear corners with zeros outside the
true image, ``sigmoid(mask)`` modulation, then one
``[N*oH*oW, k2*C] x [k2*C, outC]`` product.  It is the CPU path and the
oracle of the Hopper kernel (``ops/deform_conv_cuda.py``).

Arithmetic runs in fp32 whatever x's dtype (fp64 for fp64 x): the
interpolated, modulated columns are rounded to x's dtype (bf16 in serving)
and multiplied by the weight rounded the same way, with an fp32 sum -- the
kernel's contract.

Offsets arrive as the raw offset/mask conv output ``om`` [N, 3*k2, oH, oW]:
channels ``[0, 2*k2)`` are the (y, x) offset of each tap, interleaved per
tap in row-major tap order; channels ``[2*k2, 3*k2)`` are the mask logits.
"""
from __future__ import annotations

from typing import Optional

import torch


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - (k - 1) - 1) // stride + 1


def deform_conv2d_plain(x: torch.Tensor, weight: torch.Tensor, om: torch.Tensor,
                        *, stride: int = 1, padding: int = 1,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch DCNv2.  x [N,C,H,W]; weight [outC,C,kh,kw] (OIHW);
    om [N,3*kh*kw,oH,oW].  Returns [N,outC,oH,oW] in x's dtype,
    channels_last."""
    N, C, H, W = x.shape
    out_c, _, kh, kw = weight.shape
    oH, oW = out_size(H, kh, stride, padding), out_size(W, kw, stride, padding)
    k2 = kh * kw
    acc = torch.promote_types(x.dtype, torch.float32)
    dev = x.device

    omh = om.permute(0, 2, 3, 1).to(acc)                        # [N,oH,oW,3k2]
    off = omh[..., :2 * k2].reshape(N, oH, oW, k2, 2)
    mask = omh[..., 2 * k2:]

    iy = torch.arange(oH, dtype=acc, device=dev) * stride - padding
    ix = torch.arange(oW, dtype=acc, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=acc, device=dev)
    kx = torch.arange(kw, dtype=acc, device=dev)
    base_y = (iy[:, None, None] + ky[None, :, None]).expand(oH, kh, kw).reshape(oH, k2)
    base_x = (ix[:, None, None] + kx[None, None, :]).expand(oW, kh, kw).reshape(oW, k2)
    pos_y = base_y[None, :, None, :] + off[..., 0]             # [N,oH,oW,k2]
    pos_x = base_x[None, None, :, :] + off[..., 1]
    pos_y = pos_y.clamp(-float(padding), float(H - 1 + padding))
    pos_x = pos_x.clamp(-float(padding), float(W - 1 + padding))
    y0 = torch.floor(pos_y)
    x0 = torch.floor(pos_x)
    ly = pos_y - y0
    lx = pos_x - x0

    xf = x.permute(0, 2, 3, 1).reshape(N, H * W, C)

    def corner(yc, xc):
        valid = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
        yi = yc.clamp(0, H - 1).to(torch.int64)
        xi = xc.clamp(0, W - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(N, oH * oW * k2, 1).expand(-1, -1, C)
        v = torch.gather(xf, 1, idx).reshape(N, oH, oW, k2, C).to(acc)
        return v * valid[..., None].to(acc)

    val = (((1.0 - ly) * (1.0 - lx))[..., None] * corner(y0, x0)
           + ((1.0 - ly) * lx)[..., None] * corner(y0, x0 + 1)
           + (ly * (1.0 - lx))[..., None] * corner(y0 + 1, x0)
           + (ly * lx)[..., None] * corner(y0 + 1, x0 + 1))   # [N,oH,oW,k2,C]
    val = val * torch.sigmoid(mask)[..., None]

    # tap-major then channel: the (kh, kw, C) flatten of an HWIO kernel
    lhs = val.to(x.dtype).to(acc).reshape(N * oH * oW, k2 * C)
    rhs = weight.to(x.dtype).to(acc).permute(2, 3, 1, 0).reshape(k2 * C, out_c)
    out = (lhs @ rhs).to(x.dtype).reshape(N, oH, oW, out_c)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.permute(0, 3, 1, 2)


def deform_conv2d(x: torch.Tensor, weight: torch.Tensor, om: torch.Tensor, *,
                  stride: int = 1, padding: int = 1,
                  bias: Optional[torch.Tensor] = None,
                  packed_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DCNv2 on x's device: the plain version for a CPU tensor, the Hopper
    kernel for a CUDA tensor (it raises if it cannot launch).

    ``packed_weight`` is ``pack_dcn_weight(weight)``, which a caller that
    runs the same weight many times computes once."""
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, weight, om, stride=stride,
                                   padding=padding, bias=bias)
    from .deform_conv_cuda import dcn_fwd, pack_dcn_weight

    if packed_weight is None:
        packed_weight = pack_dcn_weight(weight)
    kh, kw = weight.shape[2:]
    cl = torch.channels_last  # no copy when the producer already wrote NHWC
    return dcn_fwd(x.contiguous(memory_format=cl), om.contiguous(memory_format=cl),
                   packed_weight, bias, ksize=(kh, kw), stride=stride,
                   padding=padding)
