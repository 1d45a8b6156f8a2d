"""int8 conv of the int8 serving mode and its Hopper kernel K5 (``csrc/conv_int8.cu``).

Counterpart of ``ppyolo_tpu/ops/conv.py::quantized_conv2d``: weights are
quantized per output channel beforehand (``eval/optimize.py::
quantize_params_int8``), the activation per tensor at run time, with a
dynamic scale ``max(amax|x|, 1e-6) / 127`` or a calibrated static one.
The int8 products are summed exactly, then dequantized in the JAX
package's order: ``(f32(acc) * (s_x * w_scale)) -> x.dtype``, then
``+ bias``.  No Pallas kernel stands behind it (XLA computes the conv in
the JAX package); the card has no int8 conv in PyTorch, so K5 is written
by hand.

Tensors are logical NCHW in channels_last memory, weights int8 OIHW.

  quantize_act       -- clip(round(f32(x) / s_x), -127, 127) as int8, round
                        half to even, a true fp32 division
  dynamic_act_scale  -- the run-time scale, on x's device, no host sync
  quantized_conv2d_plain -- K5's plain version: the products summed exactly
                        (``F.conv2d`` in fp64 on the integer values; at
                        ppyolo_2x |acc| <= 127^2 * 4608 < 2^53)
  pack_int8_weight   -- the weight in the layout K5 reads, made once by a
                        caller that reuses it (``ConvNormAct`` caches it)
  quantized_conv2d   -- the plain version for a CPU tensor, K5 for a CUDA
                        tensor (it never falls back); ``quantized_conv2d.
                        launches`` counts K5's launches
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .module import device_constant

QMAX = 127
KSIZES, STRIDES = (1, 3), (1, 2)


def dynamic_act_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(amax(|f32(x)|), 1e-6) / 127`` as a 0-d fp32 tensor on x's
    device.  The max of |x| is exact in x's own dtype (one read of x by
    ``aminmax`` over a contiguous view); the division is a true one by a
    device constant (a Python divisor would be a multiplication by its
    reciprocal on CUDA)."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        x = x.permute(0, 2, 3, 1)   # the contiguous NHWC view: aminmax copies no layout
    mn, mx = torch.aminmax(x)
    amax = torch.maximum(mx, -mn).float().clamp_min(1e-6)
    return torch.div(amax, device_constant(float(QMAX), torch.float32, x.device))


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clip(round(f32(x) / s_x), -127, 127)`` as int8 (round half to
    even, as ``jnp.round``); ``s_x`` a 0-d fp32 tensor on x's device."""
    return torch.clamp(torch.round(x.float() / s_x), -QMAX, QMAX).to(torch.int8)


def _check(x: torch.Tensor, wq: torch.Tensor, stride: int, padding: int, name: str) -> int:
    """Validate x [N,C,H,W] and wq [Co,C,k,k] int8; returns k."""
    if x.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"{name}: x and w must be 4-d, got {x.dim()}-d and {wq.dim()}-d")
    if wq.dtype != torch.int8:
        raise ValueError(f"{name}: weight must be int8, got {wq.dtype}")
    k = wq.shape[2]
    if wq.shape[1] != x.shape[1] or wq.shape[3] != k:
        raise ValueError(f"{name}: weight {tuple(wq.shape)} does not match {x.shape[1]} "
                         f"input channels")
    if k not in KSIZES or stride not in STRIDES or padding != (k - 1) // 2:
        raise ValueError(f"{name}: k {k}, stride {stride}, pad {padding} not supported "
                         f"(k in {KSIZES}, stride in {STRIDES}, pad (k-1)/2)")
    return k


def quantized_conv2d_plain(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, *,
                           stride: int = 1, padding: int = 0,
                           bias: Optional[torch.Tensor] = None,
                           act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's plain version, op for op the JAX ``quantized_conv2d``."""
    _check(x, wq, stride, padding, "quantized_conv2d_plain")
    s_x = dynamic_act_scale(x) if act_scale is None else act_scale.float().reshape(())
    xq = quantize_act(x, s_x)
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding)
    y = (acc.float() * (s_x * w_scale.float()).view(1, -1, 1, 1)).to(x.dtype)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y


def padded_channels(c: int) -> int:
    """Input channels of a tap in the packed weight: C rounded up to 16,
    so each tap starts on a 16-byte boundary of its row."""
    return (c + 15) // 16 * 16


def pack_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW [Co, C, k, k] -> K-major [Co, k*k*Cp] int8, the rows of
    K5's B tiles: column tap * Cp + c (the flatten order of an HWIO
    kernel), each tap's channels zero-padded to Cp = ``padded_channels(C)``."""
    co, c, k, _ = wq.shape
    t = wq.permute(0, 2, 3, 1)
    cp = padded_channels(c)
    if cp != c:
        t = F.pad(t, (0, cp - c))
    return t.reshape(co, k * k * cp).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launch():
    fn = _build.load("conv_int8").conv_int8_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@_build.counted
def quantized_conv2d(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, *,
                     stride: int = 1, padding: int = 0, bias: Optional[torch.Tensor] = None,
                     act_scale: Optional[torch.Tensor] = None,
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv on x's device: the plain version for a CPU tensor, K5
    for a CUDA tensor (bf16 x, even Co; it raises otherwise).  ``packed``
    is ``pack_int8_weight(wq)``, made once by a caller that reuses wq;
    without it K5's call packs wq itself.  ``act_scale`` (0-d fp32) pins a
    static scale; without it the scale is ``dynamic_act_scale(x)``."""
    k = _check(x, wq, stride, padding, "quantized_conv2d")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("quantized_conv2d has no backward: serve under torch.no_grad()")
    if x.device.type == "cpu":
        return quantized_conv2d_plain(x, wq, w_scale, stride=stride, padding=padding,
                                      bias=bias, act_scale=act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_conv2d: unsupported device {x.device}")
    n, c, h, w = x.shape
    co = wq.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"quantized_conv2d kernel takes bf16 x, got {x.dtype}")
    if co % 2:
        raise ValueError(f"quantized_conv2d kernel needs an even Co, got {co}")
    for name, t, shape in (("weight_scale", w_scale, (co,)), ("act_scale", act_scale, ())):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape
                              or t.device != x.device):
            raise ValueError(f"quantized_conv2d: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} is not fp32 {shape} on {x.device}")
    if bias is not None and (bias.dtype != x.dtype or tuple(bias.shape) != (co,)
                             or bias.device != x.device):
        raise ValueError(f"quantized_conv2d: bias {bias.dtype} {tuple(bias.shape)} is not "
                         f"{x.dtype} ({co},) on {x.device}")
    if wq.device != x.device:
        raise ValueError(f"quantized_conv2d: weight on {wq.device}, x on {x.device}")
    cp = padded_channels(c)
    if packed is None:
        packed = pack_int8_weight(wq)
    if (packed.dtype != torch.int8 or tuple(packed.shape) != (co, k * k * cp)
            or not packed.is_contiguous() or packed.device != x.device):
        raise ValueError(f"quantized_conv2d: packed weight {packed.dtype} {tuple(packed.shape)} "
                         f"on {packed.device} is not pack_int8_weight(w)")
    s_x = dynamic_act_scale(x) if act_scale is None else act_scale
    ws = w_scale.contiguous()
    # NHWC rows for the kernel's loads along C
    xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    y = torch.empty((n, co, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if xh.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("quantized_conv2d: x and the packed weight must be 16-byte aligned")
    launch = _launch()
    _build.note_launch(quantized_conv2d)
    err = launch(xh.data_ptr(), packed.data_ptr(), ws.data_ptr(), s_x.data_ptr(),
                 0 if bias is None else bias.data_ptr(), y.data_ptr(),
                 n, h, w, c, co, k, stride, oh, ow,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantized_conv2d kernel launch failed: cudaError {err}")
    return y
