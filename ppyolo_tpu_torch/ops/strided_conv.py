"""3x3 stride-2 pad-1 conv and its Hopper kernel K4 (``csrc/conv_s2.cu``).

Counterpart of ``ppyolo_tpu/ops/strided_conv_pallas.py``, the strided 3x3
of ResNet-vd's stage3_0 / stage4_0 (b8@608 serving: [8,128,152,152] ->
[8,128,76,76] and [8,256,76,76] -> [8,256,38,38]).  Like the JAX module it
is wired into no model; ``tools/probe_strided_conv.py`` measures it.

Tensors are logical NCHW in channels_last memory, weights OIHW.  Products
accumulate in fp32 and the output has x's dtype (bf16 or fp32), as the JAX
functions fix with ``preferred_element_type=jnp.float32``:

  conv_s2_conv2d -- one ``F.conv2d`` call (cuDNN on the card); the library
                    yardstick and the probe's baseline, used nowhere else
  conv_s2_phase  -- pad, 4 row/column parity planes, 9 accumulated per-tap
                    products; K4's plain version
  conv_s2        -- the plain version for a CPU tensor, K4 for a CUDA
                    tensor (it never falls back); ``conv_s2.launches``
                    counts K4's launches
  pack_conv_s2_weight -- the weight in the layout K4 reads; a caller that
                    reuses a weight packs it once and passes ``packed=``

The input must be square with an even side (the JAX kernel's
``s = h // 2``).  K4 has no backward, as the Pallas kernel has no vjp:
``conv_s2`` refuses a tensor that needs a gradient.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

DTYPES = (torch.bfloat16, torch.float32)


def conv_s2_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The strided conv as one library call, in x's dtype."""
    return F.conv2d(x, w.to(x.dtype), stride=2, padding=1)


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> int:
    """Validate x [N,C,H,H] (H even) and w [Co,C,3,3]; returns H // 2."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x and w must be 4-d, got {x.dim()}-d and {w.dim()}-d")
    _, c, h, wd = x.shape
    if h != wd or h % 2:
        raise ValueError(f"{name}: needs a square input with an even side, got {h}x{wd}")
    if tuple(w.shape[1:]) != (c, 3, 3):
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not match {c} input channels")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} not supported (bf16 or fp32)")
    return h // 2


def phase_planes(x: torch.Tensor):
    """Pad 1 and split into the 4 (row, col) parity planes, [r][c] each
    [N, C, S+1, S+1]: tap (i, j) at output (y, x) reads padded pixel
    (2y+i, 2x+j) = plane[i%2][j%2] at (y + i//2, x + j//2)."""
    xp = F.pad(x, (1, 1, 1, 1))
    return [[xp[:, :, r::2, c::2] for c in (0, 1)] for r in (0, 1)]


def conv_s2_phase(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4's plain version: 9 per-tap [N*S*S, C] @ [C, Co] products over the
    parity planes, operands in x's dtype, summed in fp32, rounded once."""
    s = _check(x, w, "conv_s2_phase")
    wf = w.to(x.dtype).float()
    planes = phase_planes(x)
    out = None
    for i in range(3):
        for j in range(3):
            p = planes[i % 2][j % 2][:, :, i // 2:i // 2 + s, j // 2:j // 2 + s]
            t = p.permute(0, 2, 3, 1).float() @ wf[:, :, i, j].t()
            out = t if out is None else out + t
    return out.to(x.dtype).permute(0, 3, 1, 2)


def pack_conv_s2_weight(w: torch.Tensor, dtype: torch.dtype = None) -> torch.Tensor:
    """OIHW [Co, C, 3, 3] -> the layout K4 reads, in ``dtype`` (w's by
    default).  GEMM column k = tap * C + c, the flatten order of an HWIO
    kernel.  bf16: K-major [Co, 9*C], the wgmma B tile's rows; fp32:
    [9*C, Co], the FMA kernel's rows."""
    dtype = dtype or w.dtype
    co, c = w.shape[:2]
    k_major = w.permute(0, 2, 3, 1).reshape(co, 9 * c)
    return (k_major.t() if dtype == torch.float32 else k_major).to(dtype).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch():
    fn = _build.load("conv_s2").conv_s2_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@_build.counted
def conv_s2(x: torch.Tensor, w: torch.Tensor, packed: torch.Tensor = None) -> torch.Tensor:
    """The strided conv on x's device: the plain version for a CPU tensor,
    K4 for a CUDA tensor (C and Co multiples of 8; it raises otherwise).
    ``packed`` is ``pack_conv_s2_weight(w, x.dtype)``, made once by a
    caller that reuses w; without it K4's call packs w itself.  The plain
    version reads w."""
    s = _check(x, w, "conv_s2")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv_s2 has no backward (nor has the Pallas kernel); "
                           "call it under torch.no_grad() or on detached tensors")
    if x.device.type == "cpu":
        return conv_s2_phase(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv_s2: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"conv_s2: weight on {w.device}, x on {x.device}")
    n, c, h, _ = x.shape
    co = w.shape[0]
    if c % 8 or co % 8:
        raise ValueError(f"conv_s2 kernel needs C % 8 == 0 and Co % 8 == 0, got C={c}, Co={co}")
    # NHWC rows for the kernel's 16-byte loads along C
    xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    if packed is None:
        packed = pack_conv_s2_weight(w, x.dtype)
    want = (co, 9 * c) if x.dtype == torch.bfloat16 else (9 * c, co)
    if (packed.dtype != x.dtype or tuple(packed.shape) != want or not packed.is_contiguous()
            or packed.device != x.device):
        raise ValueError(f"conv_s2: packed weight {packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device} is not pack_conv_s2_weight(w, {x.dtype})")
    y = torch.empty((n, co, s, s), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if xh.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("conv_s2: x and the packed weight must be 16-byte aligned")
    launch = _launch()
    _build.note_launch(conv_s2)
    err = launch(xh.data_ptr(), packed.data_ptr(), y.data_ptr(),
                 int(x.dtype == torch.float32), n, h, h, c, co,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_s2 kernel launch failed: cudaError {err}")
    return y

