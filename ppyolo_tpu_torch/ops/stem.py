"""The ResNet-vd deep stem and its fused Hopper kernel (``csrc/fused_stem.cu``).

Counterpart of ``ppyolo_tpu/ops/stem_pallas.py``.  In eval mode with bf16
compute the three stem ConvNormActs (3->32/s2, 32->32, 32->64, BN, relu)
and the 3x3/s2/p1 max-pool run as one kernel; otherwise (fp32, training)
the unfused chain runs, as ``ppyolo_tpu/models/resnet_vd.py:37-39`` does.

``fused_stem_plain`` is the kernel's plain version and repeats its
arithmetic: each conv accumulates in fp32 over bf16-valued operands, adds
the fp32 bias, applies relu and rounds to the compute dtype; then the
max-pool.  At fp32 it is the unfused op chain
(``stem_pallas.py::fused_stem_reference``).  ``fused_stem.launches`` counts
the kernel's launches.

The kernel reads its parameters in its own layout (``pack_stem_params``).
``apply_stem`` folds BN and packs once per set of parameter values and
keeps the result on the first stem module, so a served batch pays neither.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .blocks import max_pool2d
from .module import BN_EPS, store_cached
from .strided_conv import pack_conv_s2_weight

STEM_SHAPES = [(3, 32, 2), (32, 32, 1), (32, 64, 1)]  # (cin, cout, stride)


def fold_eval_bn(mod) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode conv+BN of one stem ConvNormAct as (w_eff in the weight's
    dtype, b_eff fp32): w' = w * scale/sqrt(var+eps),
    b' = bias - mean * scale/sqrt(var+eps) (+ conv bias)."""
    w = mod.conv.weight
    bn = mod.bn
    k = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    w_eff = (w.float() * k.view(-1, 1, 1, 1)).to(w.dtype)
    b_eff = bn.bias.float() - bn.running_mean.float() * k
    if mod.conv.bias is not None:
        b_eff = b_eff + mod.conv.bias.float()
    return w_eff, b_eff


def stem_eligible(mods: Sequence, x: torch.Tensor) -> bool:
    """Can the fused kernel replace these three stem ConvNormActs?  Eval
    mode, bf16, three 3x3 convs 3->32/s2, 32->32, 32->64 with BN and relu.
    Any image size: the kernel masks its own ragged tiles."""
    if x.dtype != torch.bfloat16 or any(m.training for m in mods):
        return False
    for m, (cin, cout, stride) in zip(mods, STEM_SHAPES):
        if (m.bn is None or m.use_dcn or m.ksize != 3 or m.act != "relu"
                or (m.cin, m.cout, m.stride) != (cin, cout, stride)):
            return False
    return len(mods) == 3


def fused_stem_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version of the fused stem.  x [N,3,H,W] in the compute dtype;
    w_i OIHW with BN folded, b_i fp32.  Returns [N,64,S/4,S/4]."""
    dt = x.dtype
    y = x
    for w, b, s in ((w1, b1, 2), (w2, b2, 1), (w3, b3, 1)):
        acc = F.conv2d(y.float(), w.to(dt).float(), stride=s, padding=1)
        y = F.relu(acc + b.float().view(1, -1, 1, 1)).to(dt)
    return max_pool2d(y, 3, 2, 1)


def pack_stem_params(w1, b1, w2, b2, w3, b3) -> Tuple[torch.Tensor, ...]:
    """The folded stem parameters (OIHW weights, fp32 biases) in the layout
    the kernel reads, on their device: conv1_1's weight rounded to bf16 and
    held in fp32, HWIO-flattened [27, 32] (the kernel lays it out for its
    mma.sync B fragments); conv1_2's and conv1_3's bf16 and K-major
    [Co, 288] (column tap * 32 + ci) for the wgmma B tiles; the three
    biases as one fp32 [128]."""
    for w, b, (cin, cout, _) in zip((w1, w2, w3), (b1, b2, b3), STEM_SHAPES):
        if tuple(w.shape) != (cout, cin, 3, 3) or tuple(b.shape) != (cout,):
            raise ValueError(f"fused_stem: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not match {cin}->{cout}")
    bf = torch.bfloat16
    return (w1.to(bf).float().permute(2, 3, 1, 0).reshape(27, 32).contiguous(),
            pack_conv_s2_weight(w2, bf), pack_conv_s2_weight(w3, bf),
            torch.cat([b.float() for b in (b1, b2, b3)]))


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("fused_stem")
    lib.fused_stem_launch.argtypes = _ARGTYPES
    lib.fused_stem_launch.restype = ctypes.c_int
    return lib


@_build.counted
def fused_stem(x, w1, b1, w2, b2, w3, b3, *, packed=None) -> torch.Tensor:
    """The fused stem on x's device: the plain version for a CPU tensor, the
    Hopper kernel for a CUDA tensor (bf16 only; it raises otherwise).
    ``packed`` is ``pack_stem_params(w1, ..., b3)``, made once by a caller
    that reuses the parameters; without it the kernel's call packs them.
    The plain version reads the parameters as given."""
    if x.device.type == "cpu":
        return fused_stem_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_stem kernel takes bf16, got {x.dtype}")
    N, C, H, W = x.shape
    if C != 3:
        raise ValueError(f"fused_stem: 3 input channels expected, got {C}")
    if packed is None:
        packed = pack_stem_params(w1, b1, w2, b2, w3, b3)
    xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    shapes = ((27, 32), (32, 288), (64, 288), (128,))
    dtypes = (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32)
    for t, shape, dt in zip(packed, shapes, dtypes):
        if (tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous()
                or t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"fused_stem: packed parameter {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} is not from pack_stem_params")
    if xh.data_ptr() % 16:
        raise ValueError("fused_stem: x must be 16-byte aligned")
    s2h, s2w = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    s4h, s4w = (s2h - 1) // 2 + 1, (s2w - 1) // 2 + 1
    y = torch.empty((N, 64, s4h, s4w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _lib()
    _build.note_launch(fused_stem)
    err = lib.fused_stem_launch(
        xh.data_ptr(), *(t.data_ptr() for t in packed), y.data_ptr(),
        N, H, W, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stem kernel launch failed: cudaError {err}")
    return y



def stem_params(mods: Sequence):
    """(the six folded parameters, ``pack_stem_params`` of them) for the three
    stem modules, cached on the first one and rebuilt only when a parameter
    or buffer changes (new storage, an in-place write, a dtype or device
    move)."""
    key = tuple((t.data_ptr(), t._version, t.dtype, t.device)
                for m in mods for t in (*m.parameters(), *m.buffers()))
    cache = getattr(mods[0], "_stem_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            folded = [t for m in mods for t in fold_eval_bn(m)]
            packed = pack_stem_params(*folded)
        if cache is not None:   # into the tensors a CUDA graph may read
            folded = list(store_cached(cache[1], folded))
            packed = tuple(store_cached(cache[2], packed))
        cache = (key, folded, packed, tuple(mods))
        mods[0]._stem_cache = cache
    return cache[1], cache[2]


def apply_stem(mods: Sequence, x: torch.Tensor) -> torch.Tensor:
    """conv1_1..conv1_3 (+BN +relu) + max-pool: fused where eligible."""
    if stem_eligible(mods, x):
        folded, packed = stem_params(mods)
        return fused_stem(x, *folded, packed=packed)
    for m in mods:
        x = m(x)
    return max_pool2d(x, 3, 2, 1)
