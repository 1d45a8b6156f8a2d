"""Launch wrapper of the Hopper DCNv2 forward kernel (``csrc/dcn_fwd.cu``).

It replaces ``ppyolo_tpu/ops/deform_conv_pallas.py::deform_conv2d_pallas``
on the card; ``ops/deform_conv.py::deform_conv2d_plain`` is its plain
version.  ``dcn_fwd.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .deform_conv import out_size

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("dcn_fwd")
    lib.dcn_fwd_launch.argtypes = _ARGTYPES
    lib.dcn_fwd_launch.restype = ctypes.c_int
    return lib


def pack_dcn_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [outC, C, kh, kw] -> [kh*kw*C, outC] bf16, tap-major then
    input channel (the flatten order of an HWIO kernel)."""
    out_c, c, kh, kw = weight.shape
    return (weight.permute(2, 3, 1, 0).reshape(kh * kw * c, out_c)
            .to(torch.bfloat16).contiguous())


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
    out_c = packed_weight.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dcn_fwd: x dtype {x.dtype} not supported")
    if om.dtype != x.dtype:
        raise ValueError(f"dcn_fwd: om dtype {om.dtype} != x dtype {x.dtype}")
    if tuple(om.shape) != (N, 3 * k2, oH, oW):
        raise ValueError(f"dcn_fwd: om shape {tuple(om.shape)} != "
                         f"{(N, 3 * k2, oH, oW)}")
    if packed_weight.dtype != torch.bfloat16 or tuple(packed_weight.shape) != (k2 * C, out_c):
        raise ValueError("dcn_fwd: packed_weight must be bf16 [k2*C, outC]")
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
    lib = _lib()
    dcn_fwd.launches += 1
    err = lib.dcn_fwd_launch(
        xh.data_ptr(), omh.data_ptr(), packed_weight.data_ptr(),
        0 if bias is None else bias.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.float32), N, H, W, C, oH, oW, out_c, kh, kw,
        stride, padding,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd kernel launch failed: cudaError {err}")
    return y


dcn_fwd.launches = 0
