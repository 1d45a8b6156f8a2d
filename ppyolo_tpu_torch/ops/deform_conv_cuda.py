"""Launch wrappers of the Hopper DCNv2 kernels.

K1, ``dcn_fwd`` (``csrc/dcn_fwd.cu``), replaces
``ppyolo_tpu/ops/deform_conv_pallas.py::deform_conv2d_pallas``; its plain
version is ``ops/deform_conv.py::deform_conv2d_plain``.  K3, ``dcn_bwd``
(``csrc/dcn_bwd.cu``), replaces ``_dcn_bwd_pallas``'s kernel; its plain
version is ``ops/deform_conv.py::dcn_bwd_plain``.  ``dcn_fwd.launches``
and ``dcn_bwd.launches`` count the kernels' launches (``_build.counted``;
one launch of ``dcn_bwd`` runs K3's per-(pixel, tap) pass and the gather
that sums dx).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .deform_conv import out_size

_ARGTYPES = {"dcn_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
             "dcn_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bin_cap() -> int:
    """The entries of a dx pixel's bin in K3 (a pixel with more corners
    than that takes a slower, equally exact path)."""
    fn = _build.load("dcn_bwd").dcn_bwd_bin_cap
    fn.restype = ctypes.c_int
    return fn()


def pack_dcn_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [outC, C, kh, kw] -> K-major [outC, kh*kw*C] bf16, the rows of
    K1's wgmma B tiles: column tap * C + c (the flatten order of an HWIO
    kernel), i.e. the transpose of the ``[k2*C, outC]`` GEMM operand."""
    out_c, c, kh, kw = weight.shape
    return (weight.permute(0, 2, 3, 1).reshape(out_c, kh * kw * c)
            .to(torch.bfloat16).contiguous())


@_build.counted
def dcn_fwd(x: torch.Tensor, om: torch.Tensor, packed_weight: torch.Tensor,
            bias: Optional[torch.Tensor], *, ksize: Tuple[int, int],
            stride: int, padding: int) -> torch.Tensor:
    """DCNv2 forward on the card.  x [N,C,H,W] and om [N,3*k2,oH,oW] in
    channels_last memory (physically NHWC); packed_weight from
    ``pack_dcn_weight``.  om has x's dtype (it is the offset conv's output
    on x).  fp32 x is cast to bf16 for the products, as the Pallas wrapper
    does; the result has x's dtype, channels_last."""
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd needs CUDA tensors, got {x.device}")
    kh, kw = ksize
    k2 = kh * kw
    N, C, H, W = x.shape
    oH, oW = out_size(H, kh, stride, padding), out_size(W, kw, stride, padding)
    out_c = packed_weight.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dcn_fwd: x dtype {x.dtype} not supported")
    if om.dtype != x.dtype:
        raise ValueError(f"dcn_fwd: om dtype {om.dtype} != x dtype {x.dtype}")
    if tuple(om.shape) != (N, 3 * k2, oH, oW):
        raise ValueError(f"dcn_fwd: om shape {tuple(om.shape)} != "
                         f"{(N, 3 * k2, oH, oW)}")
    if packed_weight.dtype != torch.bfloat16 or tuple(packed_weight.shape) != (out_c, k2 * C):
        raise ValueError(f"dcn_fwd: packed_weight {packed_weight.dtype} "
                         f"{tuple(packed_weight.shape)} is not pack_dcn_weight's bf16 "
                         f"K-major [outC, {k2 * C}]")
    if C % 32 or out_c % 64:
        raise ValueError(f"dcn_fwd: needs C % 32 == 0 and outC % 64 == 0, "
                         f"got C={C}, outC={out_c}")
    xh = x.to(torch.bfloat16).permute(0, 2, 3, 1)
    omh = om.permute(0, 2, 3, 1)
    for name, t in (("x", xh), ("om", omh), ("packed_weight", packed_weight)):
        if not t.is_contiguous():
            raise ValueError(f"dcn_fwd: {name} must be channels_last/contiguous")
        if t.device != x.device:
            raise ValueError(f"dcn_fwd: {name} on {t.device}, x on {x.device}")
    if xh.data_ptr() % 16 or packed_weight.data_ptr() % 16:
        raise ValueError("dcn_fwd: x and packed_weight must be 16-byte aligned")
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != (out_c,):
            raise ValueError(f"dcn_fwd: bias shape {tuple(bias.shape)}")
    y = torch.empty((N, out_c, oH, oW), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    launch = _fn("dcn_fwd")
    _build.note_launch(dcn_fwd)
    err = launch(
        xh.data_ptr(), omh.data_ptr(), packed_weight.data_ptr(),
        0 if bias is None else bias.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.float32), N, H, W, C, oH, oW, out_c, kh, kw,
        stride, padding,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd kernel launch failed: cudaError {err}")
    return y



@_build.counted
def dcn_bwd(x: torch.Tensor, om: torch.Tensor, dm: torch.Tensor, *,
            ksize: Tuple[int, int], stride: int, padding: int):
    """K3 on the card, the per-(pixel, tap) part of the DCNv2 backward.
    x [N,C,H,W] bf16 and om [N,3*k2,oH,oW] (x's layer dtype, bf16 or fp32)
    in channels_last memory; dm [N*oH*oW, k2*C] bf16 (``g @ W^T``).
    Returns dx fp32 [N,C,H,W], d_om in om's dtype (both channels_last) and
    cols [N*oH*oW, k2*C] bf16, as ``dcn_bwd_plain``.  Beside the outputs
    it allocates K3's entries (a dx pixel and a weight for each of the
    N*oH*oW*k2*4 corners) and the dx pixels' bins of (entry, weight) pairs
    with their zeroed counts."""
    if x.device.type != "cuda":
        raise ValueError(f"dcn_bwd needs CUDA tensors, got {x.device}")
    kh, kw = ksize
    k2 = kh * kw
    N, C, H, W = x.shape
    oH, oW = out_size(H, kh, stride, padding), out_size(W, kw, stride, padding)
    if x.dtype != torch.bfloat16 or dm.dtype != torch.bfloat16:
        raise ValueError(f"dcn_bwd: x and dm must be bf16, got {x.dtype}, {dm.dtype}")
    if om.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dcn_bwd: om dtype {om.dtype} not supported")
    if tuple(om.shape) != (N, 3 * k2, oH, oW):
        raise ValueError(f"dcn_bwd: om shape {tuple(om.shape)} != {(N, 3 * k2, oH, oW)}")
    if tuple(dm.shape) != (N * oH * oW, k2 * C):
        raise ValueError(f"dcn_bwd: dm shape {tuple(dm.shape)} != {(N * oH * oW, k2 * C)}")
    if C % 8:
        raise ValueError(f"dcn_bwd: needs C % 8 == 0, got C={C}")
    xh = x.permute(0, 2, 3, 1)
    omh = om.permute(0, 2, 3, 1)
    for name, t in (("x", xh), ("om", omh), ("dm", dm)):
        if not t.is_contiguous():
            raise ValueError(f"dcn_bwd: {name} must be channels_last/contiguous")
        if t.device != x.device:
            raise ValueError(f"dcn_bwd: {name} on {t.device}, x on {x.device}")
    if xh.data_ptr() % 16 or dm.data_ptr() % 16:
        raise ValueError("dcn_bwd: x and dm must be 16-byte aligned")
    cl = torch.channels_last
    dx = torch.empty((N, C, H, W), dtype=torch.float32, device=x.device, memory_format=cl)
    d_om = torch.empty((N, 3 * k2, oH, oW), dtype=om.dtype, device=x.device,
                       memory_format=cl)
    cols = torch.empty_like(dm)
    n_entries = N * oH * oW * k2 * 4
    keys = torch.empty(n_entries, dtype=torch.int32, device=x.device)
    wts = torch.empty(n_entries, dtype=torch.float32, device=x.device)
    cnt = torch.zeros(N * H * W, dtype=torch.int32, device=x.device)
    bins = torch.empty(N * H * W * _bin_cap() * 2, dtype=torch.int32, device=x.device)
    launch = _fn("dcn_bwd")
    _build.note_launch(dcn_bwd)
    err = launch(xh.data_ptr(), omh.data_ptr(), dm.data_ptr(), dx.data_ptr(),
                 d_om.data_ptr(), cols.data_ptr(), cnt.data_ptr(), bins.data_ptr(),
                 keys.data_ptr(), wts.data_ptr(), int(om.dtype == torch.float32), N, H, W, C,
                 oH, oW, kh, kw, stride, padding,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dcn_bwd kernel launch failed: cudaError {err}")
    return dx, d_om, cols

