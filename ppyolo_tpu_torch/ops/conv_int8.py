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
  k5_plan            -- K5's launch plan from the shapes (the cheapest of
                        ``k5_candidates`` by a fitted cost model): layout,
                        Co splits, shared memory, grid, quantizations per
                        input element
  quantized_conv2d   -- the plain version for a CPU tensor, K5 for a CUDA
                        tensor (it never falls back); ``quantized_conv2d.
                        launches`` counts K5's launches

K5 keeps a block's whole A tile (its pixels' input, all of C) in shared
memory where it fits: up to ``K5_MAX_C`` by (k, stride), 2272 for a 1x1,
1440 for a 3x3 at stride 1, 416 at stride 2 (the widest of the repo's
configs are 2050, 514 and 256).  A wider conv takes the streamed layout:
the A tile holds one chunk of C at a time, quantized once per Co tile.
Any Co, odd too.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

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
    # a program torch.export traces makes its divisor on the device (a kept
    # constant would be a host tensor copied in at every call)
    qmax = (torch.full_like(amax, float(QMAX)) if torch.compiler.is_exporting()
            else device_constant(float(QMAX), torch.float32, x.device))
    return torch.div(amax, qmax)


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
    """Input channels of a tap in the packed weight and in K5's A tile: C
    rounded up to 32, one wgmma k32 step of int8."""
    return (c + 31) // 32 * 32


def pack_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW [Co, C, k, k] -> group-major [k*k*Cp/16, Co, 16] int8, the
    rows of K5's B chunks: K column tap * Cp + c (the flatten order of an
    HWIO kernel, each tap's channels zero-padded to Cp =
    ``padded_channels(C)``) in 16-byte groups, each group's Co rows
    consecutive."""
    co, c, k, _ = wq.shape
    t = wq.permute(0, 2, 3, 1)
    cp = padded_channels(c)
    if cp != c:
        t = F.pad(t, (0, cp - c))
    return t.reshape(co, k * k * cp // 16, 16).transpose(0, 1).contiguous()


# K5's fixed shape (csrc/conv_int8.cu) and the H100 it is planned for
K5_WN = 128               # output channels of one warpgroup's wgmma m64n128k32
K5_KC = 64                # K bytes of one weight ring stage
K5_STAGES = 5             # weight ring depth
SMEM_BLOCK_MAX = 232448   # 227 KB: the most shared memory a block may opt in to
SMEM_SM = 233472          # 228 KB an SM; the runtime reserves 1 KB a block
SMS = 132                 # SMs of an H100 SXM (the wrapper reads the card's own count)
LAYOUTS = ((2, 1), (1, 1), (2, 2))   # (wg_m, m_tiles) K5 is built for
# the widest C a resident A tile (all of C) fits in shared memory, by (k,
# stride); past it the plan streams C through the A tile in chunks
K5_MAX_C = {(1, 1): 2272, (1, 2): 2272, (3, 1): 1440, (3, 2): 416}
REG_BLOCKS = {1: 2, 2: 1}  # blocks an SM by registers, by m_tiles (__launch_bounds__)
# The cost model of one block, in SM cycles, that picks between plans: int8
# tensor-core ops a cycle, the SM's bytes a cycle from device memory (the A
# tile's bf16 reads, the output's writes) and from L2 (the weight), quantized
# elements a cycle, a fixed start-up and drain, and the share of the shorter
# of a block's products and A tile that a co-resident block does not hide.
# Fitted (``tools/k5_plans.py --fit``) to every plan's time at the 32
# ppyolo_2x@608 b8 shapes on an H100 80GB HBM3 at 700 W; the plans it picks
# there come within 1.1% of the fastest plan of each shape.
_OPS_CYCLE, _DRAM_B_CYCLE, _L2_B_CYCLE, _QUANT_CYCLE, _FIXED_CYCLES, _OVERLAP = (
    5920.0, 12.1, 18.6, 12.7, 950.0, 0.64)


@dataclass(frozen=True)
class K5Plan:
    """How K5 runs one conv (see ``k5_plan``)."""
    wg_m: int                  # warpgroups along M: 2 (both on BN 128) or 1 (splitting BN 256)
    m_tiles: int               # m64 tiles of a warpgroup: 1, or 2 (wg_m 2: BM 256)
    bm: int                    # output pixels of a block
    bn: int                    # output channels of a Co tile
    cp: int                    # padded input channels of a tap
    patch: Optional[Tuple[int, int]]   # 3x3: a block's (rows, columns) of output pixels
    planes: Tuple[int, int, int]       # 3x3: the A tile's parity planes (count, rows, columns)
    a_slots: int               # pixel slots of the A tile
    c_chunk: int               # channels of the A tile: cp (resident), or a chunk of C (streamed)
    co_tiles: int              # Co tiles of bn channels
    tiles_per_block: int       # Co tiles a block walks with its A tile resident
    grid: Tuple[int, int]      # (pixel blocks, Co splits)
    smem_bytes: int            # dynamic shared memory of a block
    blocks_per_sm: int         # by shared memory and registers
    quant_per_element: float   # quantizations of each input element the conv reads
    cost_cycles: float         # the model's SM cycles (to choose between plans)

    @property
    def co_splits(self) -> int:
        return self.grid[1]

    @property
    def streamed(self) -> bool:
        return self.c_chunk < self.cp


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _covered(n_out: int, tile: int, stride: int, pad: int, n_in: int, span: int) -> int:
    """Sum over the tiles of one axis of the input positions in [0, n_in)
    that a tile's A slots hold (a tile starts at output tile * i and holds
    ``span`` input positions from tile * i * stride - pad)."""
    total = 0
    for i in range(_cdiv(n_out, tile)):
        lo = i * tile * stride - pad
        total += max(0, min(n_in, lo + span) - max(0, lo))
    return total


def _read_positions(n_out: int, k: int, stride: int, pad: int, n_in: int) -> int:
    """Input positions of one axis that the conv reads."""
    return len({o * stride + d - pad for o in range(n_out) for d in range(k)}
               & set(range(n_in)))


def _plan(n, h, w, c, co, k, stride, wg_m, m_tiles, tiles_per_block,
          sms: int = SMS, c_chunk: Optional[int] = None) -> Optional[K5Plan]:
    """One plan; ``c_chunk`` (a multiple of K5_KC below cp) streams C
    through the A tile in chunks of that many channels."""
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    pad, cp = (k - 1) // 2, padded_channels(c)
    cc = cp if c_chunk is None else c_chunk
    streamed = cc < cp
    bm, bn = 64 * wg_m * m_tiles, K5_WN * 2 // wg_m
    if k == 1:
        patch, planes, a_slots = None, (0, 0, 0), bm
        m_blocks = _cdiv(n * oh * ow, bm)
        quantized = n * oh * ow                       # input pixels quantized a split
        read = n * oh * ow
    else:
        patch = (8 * wg_m, 8 * m_tiles)
        spans = [(t - 1) * stride + k for t in patch]  # the halo's rows and columns
        rows, cols = (_cdiv(s_, stride) for s_ in spans)
        planes = (stride * stride, rows, cols)
        a_slots = stride * stride * rows * cols
        m_blocks = n * _cdiv(oh, patch[0]) * _cdiv(ow, patch[1])
        quantized = n * (_covered(oh, patch[0], stride, pad, h, rows * stride)
                         * _covered(ow, patch[1], stride, pad, w, cols * stride))
        read = n * (_read_positions(oh, k, stride, pad, h) * _read_positions(ow, k, stride, pad, w))
    a_bytes = _cdiv(a_slots * cc, 128) * 128
    # A tile, weight ring, slot and row tables, two tiles' epilogue scales and biases
    smem = a_bytes + K5_STAGES * bn * K5_KC + _cdiv(4 * (a_slots + bm), 16) * 16 + 16 * bn + 128
    if cp % K5_KC and not streamed:   # a tap's phantom k32 step reads 2 groups past the A tile
        smem = max(smem, a_bytes + 2 * a_slots * 16 + 128)
    if smem > SMEM_BLOCK_MAX:
        return None
    co_tiles = _cdiv(co, bn)
    splits = _cdiv(co_tiles, tiles_per_block)
    bps = min(REG_BLOCKS[m_tiles], SMEM_SM // (smem + 1024))
    taps = k * k
    t_tile = max(bm * bn * taps * _cdiv(cp, K5_KC) * K5_KC * 2 / _OPS_CYCLE,
                 bm * bn * 2 / _DRAM_B_CYCLE, bn * taps * cp / _L2_B_CYCLE)
    t_a = max(a_slots * cp / _QUANT_CYCLE, a_slots * c * 2 / _DRAM_B_CYCLE)
    if streamed:   # every Co tile quantizes its chunks anew
        t_a *= tiles_per_block
        quantized *= co_tiles / splits
    t_prod = tiles_per_block * t_tile
    if bps > 1:   # a co-resident block's products run under this one's A tile, and back
        block = max(t_prod, t_a) + _OVERLAP * min(t_prod, t_a) + _FIXED_CYCLES
    else:
        block = t_prod + t_a + _FIXED_CYCLES
    cost = _cdiv(m_blocks * splits, sms * bps) * bps * block
    return K5Plan(wg_m=wg_m, m_tiles=m_tiles, bm=bm, bn=bn, cp=cp, patch=patch, planes=planes,
                  a_slots=a_slots, c_chunk=cc, co_tiles=co_tiles,
                  tiles_per_block=tiles_per_block,
                  grid=(m_blocks, splits), smem_bytes=smem, blocks_per_sm=bps,
                  quant_per_element=splits * quantized / read, cost_cycles=cost)


def k5_candidates(n: int, h: int, w: int, c: int, co: int, k: int, stride: int,
                  sms: int = SMS) -> list:
    """Every resident plan of the conv (the A tile holds all of C) that
    fits shared memory: each layout of ``LAYOUTS`` (BM 128 x BN 128, BM 64
    x BN 256, BM 256 x BN 128), each number of Co tiles a block walks;
    costed for ``sms`` SMs."""
    plans = []
    for wg_m, m_tiles in LAYOUTS:
        tiles = _cdiv(co, K5_WN * 2 // wg_m)
        for tpb in sorted({_cdiv(tiles, s) for s in range(1, tiles + 1)}):
            p = _plan(n, h, w, c, co, k, stride, wg_m, m_tiles, tpb, sms)
            if p is not None:
                plans.append(p)
    return plans


def k5_streamed_candidates(n: int, h: int, w: int, c: int, co: int, k: int, stride: int,
                           sms: int = SMS) -> list:
    """The streamed plans of a conv too wide for a resident A tile: each
    layout with one Co tile a block and, as its A chunk, the widest
    multiple of K5_KC channels that fits one block an SM and, where
    registers allow two, the widest that fits two."""
    plans = []
    for wg_m, m_tiles in LAYOUTS:
        fits = {}
        for cc in range(K5_KC, padded_channels(c), K5_KC):
            p = _plan(n, h, w, c, co, k, stride, wg_m, m_tiles, 1, sms, cc)
            if p is not None:
                fits[p.blocks_per_sm] = p    # the widest chunk at each occupancy
        plans += list(fits.values())
    return plans


@functools.lru_cache(maxsize=None)
def k5_plan(n: int, h: int, w: int, c: int, co: int, k: int, stride: int,
            sms: int = SMS) -> K5Plan:
    """K5's plan for x [n, c, h, w] and a [co, c, k, k] weight on a card
    of ``sms`` SMs: of ``k5_candidates``, the one the cost model finds
    fastest, then the one that quantizes each element fewest times.  A
    block's A tile holds its pixels' input, quantized once; a conv
    quantizes each input element ``quant_per_element`` times: the Co splits
    (1x1) times the halos' overlap (3x3).  Past ``K5_MAX_C`` no resident
    plan fits: the cheapest of ``k5_streamed_candidates``."""
    plans = (k5_candidates(n, h, w, c, co, k, stride, sms)
             or k5_streamed_candidates(n, h, w, c, co, k, stride, sms))
    return min(plans, key=lambda p: (p.cost_cycles, p.quant_per_element))


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device: the plan fills them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    for a CUDA tensor (bf16 x; it raises otherwise).  ``packed`` is ``pack_int8_weight(wq)``, made once by a
    caller that reuses wq; without it K5's call packs wq itself.
    ``act_scale`` (0-d fp32) pins a static scale; without it the scale is
    ``dynamic_act_scale(x)``."""
    k = _check(x, wq, stride, padding, "quantized_conv2d")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("quantized_conv2d has no backward: serve under torch.no_grad()")
    if _build.recording():
        from ..utils.mfu import conv_int8_flops

        n, c, h, w = x.shape
        ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
        _build.note_call("conv_int8", conv_int8_flops(n, ho, wo, wq.shape[0], c, k), x.is_cuda)
    if x.device.type == "cpu":
        return quantized_conv2d_plain(x, wq, w_scale, stride=stride, padding=padding,
                                      bias=bias, act_scale=act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_conv2d: unsupported device {x.device}")
    n, c, h, w = x.shape
    co = wq.shape[0]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"quantized_conv2d kernel takes bf16 x, got {x.dtype}")
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
    plan = k5_plan(n, h, w, c, co, k, stride, sm_count(x.device))
    if packed is None:
        packed = pack_int8_weight(wq)
    if (packed.dtype != torch.int8 or tuple(packed.shape) != (k * k * plan.cp // 16, co, 16)
            or not packed.is_contiguous() or packed.device != x.device):
        raise ValueError(f"quantized_conv2d: packed weight {packed.dtype} {tuple(packed.shape)} "
                         f"on {packed.device} is not pack_int8_weight(w)")
    if n * h * w * max(c, co) >= 2 ** 31:
        raise ValueError(f"quantized_conv2d: x {tuple(x.shape)} -> {co} channels needs 64-bit "
                         f"pixel indices")
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
    _, rows, cols = plan.planes
    err = launch(xh.data_ptr(), packed.data_ptr(), ws.data_ptr(), s_x.data_ptr(),
                 0 if bias is None else bias.data_ptr(), y.data_ptr(),
                 n, h, w, c, co, k, stride, plan.wg_m, plan.m_tiles, plan.tiles_per_block,
                 rows, cols,
                 plan.a_slots, plan.c_chunk, *plan.grid, plan.smem_bytes,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantized_conv2d kernel launch failed: cudaError {err}")
    return y


@torch.library.custom_op("ppyolo::quantized_conv2d", mutates_args=())
def quantized_conv2d_op(x: torch.Tensor, wq: torch.Tensor, packed: torch.Tensor,
                        w_scale: torch.Tensor, act_scale: torch.Tensor,
                        bias: Optional[torch.Tensor], stride: int, padding: int) -> torch.Tensor:
    """K5 as an operator of the ``ppyolo`` library, the form an int8
    ``torch.export`` artifact holds (``eval/export.py``): ``quantized_conv2d``
    with the activation scale as an input (the calibrated buffer, or
    ``dynamic_act_scale(x)`` computed in the program) and the weight both
    as it is (the plain version's, on a CPU tensor) and packed (K5's, on a
    CUDA tensor)."""
    return quantized_conv2d(x, wq, w_scale, stride=stride, padding=padding, bias=bias,
                            act_scale=act_scale, packed=packed if x.is_cuda else None)


@quantized_conv2d_op.register_fake
def _quantized_conv2d_fake(x, wq, packed, w_scale, act_scale, bias, stride, padding):
    n, _, h, w = x.shape
    k = wq.shape[2]
    return torch.empty((n, wq.shape[0], (h + 2 * padding - k) // stride + 1,
                        (w + 2 * padding - k) // stride + 1), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)
