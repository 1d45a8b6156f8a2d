"""Model-FLOPs utilization (``ppyolo_tpu/utils/mfu.py``).

MFU = (FLOPs of a unit of work / its seconds) / the card's peak.  The JAX
package reads a program's FLOPs from XLA's cost analysis of the lowered
program and adds the hand-derived FLOPs of each Pallas kernel that runs
as a kernel (XLA counts a custom call as 0; an interpreted kernel is
ordinary HLO it already counts).  The port runs the unit once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the aten
convolutions and matrix products, and adds each hand-written kernel's
FLOPs from its formula below, only where the kernel launched: on the CPU
the kernels' plain versions run through aten and the mode counts them
itself.  Each formula equals the mode's count of the kernel's plain
version at the same shape (matrix work only: the mode counts no
elementwise arithmetic), so a unit counts the same on the card and on the
CPU.  The formulas live here and nowhere else: the wrappers report their
calls with them (``ops/_build.py::note_call``) and ``chip_smoke.py``'s
bounds take them.

``train/graphs.py`` counts each unit shape once, on the eager run that
precedes its capture on a card (the first run on the CPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from ..ops import _build

# Dense bf16 tensor-core peak FLOP/s (fp32 accumulate) by
# ``torch.cuda.get_device_name``: NVIDIA H100 SXM5 (80 GB HBM3), 989.4
# TFLOP/s dense, from NVIDIA's H100 datasheet.  Any other name is unknown.
_PEAK_BY_NAME = {"NVIDIA H100 80GB HBM3": 989e12}


def peak_flops_per_chip(device=None) -> Optional[float]:
    """Peak bf16 FLOP/s of one card, or None when unknown (the CPU, a card
    not in the table)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return _PEAK_BY_NAME.get(torch.cuda.get_device_name(device))


def mfu(flops: Optional[float], seconds: float, n_chips: int = 1,
        device=None) -> Optional[float]:
    """Achieved fraction of peak (0..1), or None when the peak or the
    FLOPs are unknown."""
    peak = peak_flops_per_chip(device)
    if not flops or not peak or seconds <= 0:
        return None
    return flops / seconds / (peak * n_chips)


# -- the kernels' FLOPs (matrix work; module docstring) ----------------------

def conv_flops(n: int, ho: int, wo: int, co: int, c: int, k: int) -> float:
    """A k x k convolution (or its implicit GEMM): 2 N Ho Wo Co C k^2."""
    return 2.0 * n * ho * wo * co * c * k * k


def dcn_fwd_flops(n: int, oh: int, ow: int, k2: int, c: int, co: int) -> float:
    """K1 (``csrc/dcn_fwd.cu``): the [P, k2 C] x [k2 C, Co] product,
    2 P k2 C Co with P = N oH oW (the bilinear gather is not counted)."""
    return 2.0 * n * oh * ow * k2 * c * co


def dcn_bwd_flops(n: int, oh: int, ow: int, k2: int, c: int) -> float:
    """K3 (``csrc/dcn_bwd.cu``): no matrix work (dx, d_offset, d_mask and
    the columns are per-element sums); the products around it
    (``dm = g W^T``, ``dW = cols^T g``) are aten matmuls the mode counts."""
    return 0.0


def dcn_bwd_ops(n: int, oh: int, ow: int, k2: int, c: int) -> float:
    """K3's fp32 arithmetic on the CUDA cores, for its bound (not MFU): per
    (pixel, tap, channel) the bilinear sample 7, dmod 2, dsamp 1, the
    scatter 8, the corner dots 8, the column 1."""
    return 27.0 * n * oh * ow * k2 * c


def fused_stem_flops(n: int, h: int, w: int) -> float:
    """K2 (``csrc/fused_stem.cu``): the three 3x3 convs 3->32/s2, 32->32,
    32->64 at the half-size grid (the pool does no matrix work)."""
    s2h, s2w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return sum(conv_flops(n, s2h, s2w, co, c, 3) for c, co in ((3, 32), (32, 32), (32, 64)))


def conv_s2_flops(n: int, s: int, c: int, co: int) -> float:
    """K4 (``csrc/conv_s2.cu``): a 3x3/s2 conv to an s x s output."""
    return conv_flops(n, s, s, co, c, 3)


def conv_int8_flops(n: int, ho: int, wo: int, co: int, c: int, k: int) -> float:
    """K5 (``csrc/conv_int8.cu``): the int8 implicit GEMM, 2 N Ho Wo Co k^2 C
    (integer operations, counted as FLOPs as the mode counts the plain
    version's fp64 conv)."""
    return conv_flops(n, ho, wo, co, c, k)


def nms_keep_flops(*_shape) -> float:
    """K6 (``csrc/nms_keep.cu``): no matrix work."""
    return 0.0


def nms_keep_ops(iou_pairs: int) -> float:
    """K6's fp32 arithmetic, for its bound (not MFU): 12 a candidate pair
    whose IoU the walk needs."""
    return 12.0 * iou_pairs


# -- counting ----------------------------------------------------------------

def kernel_flops(fn: Callable, *args, **kwargs) -> List[Tuple[str, float, bool]]:
    """``[(kernel, flops, launched), ...]``: every hand-written kernel's
    place that ``fn(*args)`` reached, in order, with its formula's FLOPs
    and whether the kernel launched (False where its plain version ran, as
    JAX's ``custom_call_flops`` marks an interpreted kernel).  Runs ``fn``."""
    with _build.recording_calls() as calls:
        fn(*args, **kwargs)
    return list(calls)


@dataclasses.dataclass
class Count:
    """FLOPs of what ran inside ``counting()``: ``aten`` (the mode's count),
    ``kernels`` (each call ``(name, flops, launched)``) and ``total`` (the
    mode's count plus the launched kernels')."""

    aten: float = 0.0
    kernels: List[Tuple[str, float, bool]] = dataclasses.field(default_factory=list)

    @property
    def total(self) -> float:
        return self.aten + sum(f for _, f, launched in self.kernels if launched)


@contextlib.contextmanager
def counting():
    """Count the FLOPs of what runs inside the block (a ``Count``, filled
    as the block exits)."""
    from torch.utils.flop_counter import FlopCounterMode

    c = Count()
    with _build.recording_calls() as calls, FlopCounterMode(display=False) as mode:
        yield c
    c.aten = float(mode.get_total_flops())
    c.kernels = list(calls)


def program_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args)`` (runs it)."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.total
