"""K5's host plan (``ops/conv_int8.py::k5_plan``) and the kernel's tile
addressing, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_port_gpu.py``
holds it bit-equal to the plain version there).  Here:

* the plan at every int8 conv shape of ppyolo_2x served at 608 x 608,
  batch 8 (``eval.optimize.int8_conv_shapes``: hooks in one 32-px forward,
  every map 19x larger at 608): shared memory within the 227 KB a block
  may use, every output pixel and channel written by exactly one block,
  and the quantizations of each input element the plan states (the Co
  splits for a 1x1; times the halo's overlap for a 3x3), summed a batch as
  ``PERF.md`` quotes them;
* a plan for every int8 conv of every config at the sizes and batches its
  entries serve, all resident (the A tile holds all of C); ``K5_MAX_C``, the
  widest C a resident plan fits, and past it the streamed plans (C through
  the A tile in chunks); odd Co;
* K5's quotient (a reciprocal multiply and one exact FMA correction)
  emulated in numpy gives ``quantize_act``'s int8 for every finite bf16
  bit pattern at scales across the dynamic range;
* a numpy emulation of ``csrc/conv_int8.cu``'s addressing: the slot table,
  the A tile in wgmma's non-swizzled K-major layout, each tap's descriptor
  (start, LBO, SBO) over it, the weight ring's chunks of
  ``pack_int8_weight``'s group-major layout, the phantom second k32 step on
  a zero-filled B (its A bytes past the tile are garbage), and the
  epilogue's row table: the int32 sums equal the exact conv of the
  quantized activation, for 1x1 and 3x3, stride 1 and 2, ragged pixel and
  Co tails, C tails 2 mod 8 and odd, every warpgroup layout, C streamed in
  chunks, odd Co.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from configs import CONFIGS, PPYOLO_2x_Config
from ppyolo_tpu_torch.eval.optimize import int8_conv_class, int8_conv_shapes
from ppyolo_tpu_torch.models import PPYOLO
from ppyolo_tpu_torch.ops import conv_int8 as ci
from ppyolo_tpu_torch.ops.conv_int8 import (K5_KC, K5_MAX_C, K5_STAGES, SMEM_BLOCK_MAX, _plan,
                                            k5_plan, pack_int8_weight, quantize_act)

BATCH, SIZE = 8, 608


@functools.lru_cache(maxsize=None)
def ppyolo_2x_int8_shapes():
    """[(N, H, W, C, Co, k, stride, convs)] of ppyolo_2x's int8 convs at
    SIZE, batch BATCH (``int8_conv_shapes``: hooks in a 32-px forward)."""
    shapes = int8_conv_shapes(PPYOLO.from_config(PPYOLO_2x_Config()).eval(), SIZE, BATCH)
    assert sum(s[-1] for s in shapes) == 65
    return [(BATCH, h, w, c, co, k, s, n) for c, h, w, co, k, s, n in shapes]


def test_the_int8_convs_are_65_in_32_shapes_and_4_classes():
    shapes = ppyolo_2x_int8_shapes()
    assert len(shapes) == 32
    by_class = {}
    for n, h, w, c, co, k, s, count in shapes:
        cls = int8_conv_class(k, c, s)
        by_class[cls] = by_class.get(cls, 0) + count
    assert by_class == {"3x3 s1": 20, "3x3 s2": 2, "1x1 C%8=0": 34, "1x1 C=2 mod 8": 9}


def _coverage(plan, n, h, w, co, k, stride):
    """How many times each (output pixel, Co tile) is written: the blocks
    of the plan's grid decomposed as the kernel decomposes blockIdx."""
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    tiles = np.zeros((plan.grid[1], plan.co_tiles), np.int64)
    for by in range(plan.grid[1]):
        t0 = by * plan.tiles_per_block
        tiles[by, t0:min(t0 + plan.tiles_per_block, plan.co_tiles)] = 1
    if k == 1:
        rows = np.zeros(n * oh * ow, np.int64)
        for bx in range(plan.grid[0]):
            rows[bx * plan.bm:(bx + 1) * plan.bm] += 1
        rows = rows.reshape(n, oh, ow)
    else:
        ph, pw = plan.patch
        ty, tx = -(-oh // ph), -(-ow // pw)
        assert plan.grid[0] == n * ty * tx
        rows = np.zeros((n, ty * ph, tx * pw), np.int64)
        for bx in range(plan.grid[0]):
            b, r = divmod(bx, ty * tx)
            y0, x0 = (r // tx) * ph, (r % tx) * pw
            rows[b, y0:y0 + ph, x0:x0 + pw] += 1
        rows = rows[:, :oh, :ow]
    return rows, tiles.sum(0)


@pytest.mark.parametrize("shape", range(32))
def test_k5_plan_fits_and_writes_every_output_once(shape):
    n, h, w, c, co, k, stride, _ = ppyolo_2x_int8_shapes()[shape]
    p = k5_plan(n, h, w, c, co, k, stride)
    assert p.smem_bytes <= SMEM_BLOCK_MAX == 227 * 1024
    a_bytes = -(-p.a_slots * p.cp // 128) * 128
    tables = -(-4 * (p.a_slots + p.bm) // 16) * 16
    assert p.smem_bytes >= a_bytes + K5_STAGES * p.bn * K5_KC + tables + 16 * p.bn + 128
    # a tap with an odd number of k32 steps reads 2 groups past the A tile
    # in its phantom step: inside the block's shared memory
    assert p.cp % 64 == 0 or a_bytes + 2 * p.a_slots * 16 + 128 <= p.smem_bytes
    assert p.blocks_per_sm == min(3 - p.m_tiles, 233472 // (p.smem_bytes + 1024)) >= 1
    assert (p.wg_m, p.m_tiles) in ((2, 1), (1, 1), (2, 2))
    assert (p.bm, p.bn) == (64 * p.wg_m * p.m_tiles, 256 // p.wg_m)
    rows, tiles = _coverage(p, n, h, w, co, k, stride)
    assert (rows == 1).all() and (tiles == 1).all()
    assert p.co_tiles * p.bn >= co > (p.co_tiles - 1) * p.bn
    # every Co split has a tile; no split is empty
    assert (p.grid[1] - 1) * p.tiles_per_block < p.co_tiles <= p.grid[1] * p.tiles_per_block
    if k == 1:
        assert p.quant_per_element == p.co_splits
    else:   # the halo's overlap: at most 10 x 10 slots for 8 x 8 pixels at stride 1
        assert 1.0 < p.quant_per_element / p.co_splits < 1.6


# Quantizations a b8@608 batch by class (the plan's quant_per_element times
# the input elements each conv reads, summed over the 65 convs), as PERF.md
# quotes them; before this plan every element was quantized once per tap and
# once per 128-channel column block.
QUANT_G_PER_BATCH = {"3x3 s1": 0.1776, "3x3 s2": 0.04, "1x1 C%8=0": 0.4776,
                     "1x1 C=2 mod 8": 0.1039}


def test_k5_plan_quantizations_a_batch_by_class():
    got = {}
    for n, h, w, c, co, k, stride, count in ppyolo_2x_int8_shapes():
        p = k5_plan(n, h, w, c, co, k, stride)
        read = n * h * w * c if stride == 1 or k == 3 else n * -(-h // 2) * -(-w // 2) * c
        cls = int8_conv_class(k, c, stride)
        got[cls] = got.get(cls, 0.0) + count * p.quant_per_element * read / 1e9
    assert {k: round(v, 4) for k, v in got.items()} == QUANT_G_PER_BATCH


def test_k5_plan_splits_co_only_to_fill_the_card():
    """At M = 2888 (19x19, b8) a 1x1 has 23 blocks of 128 pixels: the plan
    splits Co; at 76x76 it does not; wide C takes BM 64."""
    p = k5_plan(8, 19, 19, 512, 2048, 1, 1)
    assert p.bm == 128 and p.grid[0] == 23 and p.co_splits > 1
    assert k5_plan(8, 76, 76, 512, 256, 1, 1).co_splits == 1
    assert k5_plan(8, 19, 19, 2050, 512, 1, 1).wg_m == 1
    assert _plan(8, 19, 19, 2050, 512, 1, 1, 2, 1, 4) is None     # 128 x 2080 bytes do not fit
    wide = k5_plan(1, 8, 8, 8192, 64, 3, 1)       # no resident plan fits: C streams
    assert wide.streamed and not ci.k5_candidates(1, 8, 8, 8192, 64, 3, 1)
    # the splits follow the card's SMs: one SM gains nothing from a split
    assert k5_plan(8, 19, 19, 512, 2048, 1, 1, sms=1).co_splits == 1
    assert k5_plan(8, 19, 19, 512, 2048, 1, 1, sms=66).co_splits < p.co_splits


@pytest.mark.parametrize("k,stride", sorted(K5_MAX_C))
def test_k5_max_c_is_the_widest_c_a_plan_fits(k, stride):
    """``K5_MAX_C`` is the resident/streamed boundary: at it a resident
    plan (the A tile holds all of C), one channel past it none fits and the
    plan streams C in chunks."""
    c = K5_MAX_C[k, stride]
    p = k5_plan(8, 64, 64, c, 256, k, stride)
    assert p.smem_bytes <= SMEM_BLOCK_MAX and not p.streamed and p.c_chunk == p.cp
    assert not ci.k5_candidates(8, 64, 64, c + 1, 256, k, stride)
    q = k5_plan(8, 64, 64, c + 1, 256, k, stride)
    assert q.streamed and q.smem_bytes <= SMEM_BLOCK_MAX and q.c_chunk % K5_KC == 0


@pytest.mark.parametrize("shape", [(8, 19, 19, 4096, 512, 1, 1), (8, 19, 19, 2048, 512, 3, 1),
                                   (8, 38, 38, 1024, 256, 3, 2), (8, 19, 19, 2300, 255, 1, 2),
                                   (1, 8, 8, 8192, 64, 3, 1)])
def test_k5_plan_streams_c_past_the_resident_tile(shape):
    """Past ``K5_MAX_C`` the plan streams C: an A chunk of a multiple of
    K5_KC channels below Cp that fits shared memory, one Co tile a block,
    every output written once, each input element quantized once per Co
    tile (times the halo's overlap for a 3x3)."""
    n, h, w, c, co, k, stride = shape
    p = k5_plan(*shape)
    assert p.streamed and p.c_chunk % K5_KC == 0 and K5_KC <= p.c_chunk < p.cp
    assert p.smem_bytes <= SMEM_BLOCK_MAX and p.tiles_per_block == 1
    assert p.smem_bytes >= (-(-p.a_slots * p.c_chunk // 128) * 128 + K5_STAGES * p.bn * K5_KC
                            + 16 * p.bn + 128)
    rows, tiles = _coverage(p, n, h, w, co, k, stride)
    assert (rows == 1).all() and (tiles == 1).all()
    if k == 1:
        assert p.quant_per_element == p.co_tiles
    else:
        assert 1.0 <= p.quant_per_element / p.co_tiles < 2.5


@pytest.mark.parametrize("co", [1, 37, 255, 513])
def test_k5_plan_takes_an_odd_co(co):
    """An odd Co plans like the even Co above it: its last Co tile ragged."""
    for k, stride in ((1, 1), (3, 1), (3, 2)):
        p, q = k5_plan(8, 19, 19, 256, co, k, stride), k5_plan(8, 19, 19, 256, co + 1, k, stride)
        assert (p.wg_m, p.m_tiles, p.co_tiles) == (q.wg_m, q.m_tiles, q.co_tiles)
        rows, tiles = _coverage(p, 8, 19, 19, co, k, stride)
        assert (rows == 1).all() and (tiles == 1).all()


@pytest.mark.parametrize("index", sorted(CONFIGS))
def test_every_config_plans_every_int8_conv_it_serves(index):
    """Every int8 conv of each config gets a plan at the sizes and batches
    its int8 entries serve (eval and test_dev at the eval size and batch,
    the demo at the test size, batch 1), within ``K5_MAX_C``: a resident
    plan, as before C could stream."""
    cfg = CONFIGS[index]()
    model = PPYOLO.from_config(cfg).eval()
    serves = {(cfg.eval_cfg["target_size"], cfg.eval_cfg["eval_batch_size"]),
              (cfg.test_cfg["target_size"], 1)}
    for size, batch in sorted(serves):
        shapes = int8_conv_shapes(model, size, batch)
        assert shapes
        for c, h, w, co, k, stride, _ in shapes:
            assert c <= K5_MAX_C[k, stride]
            p = k5_plan(batch, h, w, c, co, k, stride)
            assert p.smem_bytes <= SMEM_BLOCK_MAX and batch * h * w * max(c, co) < 2 ** 31
            assert not p.streamed and p in ci.k5_candidates(batch, h, w, c, co, k, stride)


# ---------------------------------------------------------------- the kernel's quotient

def _fma32(a, b, c):
    """fp32 fma(a, b, c) through fp64: the product of two fp32 is exact in
    fp64, and the sum is rounded twice only where the fp64 sum is not exact
    (never for the remainder, which is exact in fp32)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def k5_quantize(v, s):
    """csrc/conv_int8.cu::quant1<false> in numpy: v fp32, s an fp32 scale."""
    s = np.float32(s)
    r = np.float32(1) / s                               # __frcp_rn
    with np.errstate(over="ignore", invalid="ignore"):
        q0 = v * r
        q1 = _fma32(_fma32(-q0, np.full_like(v, s), v), np.full_like(v, r), q0)
    t = np.where(np.abs(q0) < 256, q1, q0)
    t = np.minimum(np.maximum(t, -127), 127)
    return np.rint(t).astype(np.int8)                    # round half to even


def test_k5_quotient_quantizes_every_bf16_as_quantize_act():
    """Every finite bf16 bit pattern at the gpu test's scales, at scales
    whose reciprocal is inexact and which put exact halves in reach (3, 5
    and 7 times a power of 2; there the reciprocal multiply alone rounds
    some halves the wrong way), and at 60 more, log-uniform from 1e-8 to
    1e4: the same int8 as ``quantize_act`` (a true fp32 division)."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = bits[torch.isfinite(bits.float())]
    v = x.float().numpy()
    rng = np.random.RandomState(0)
    scales = ([1e-6 / 127, 0.02, 1e-4] + [m * 2.0 ** -e for m in (3, 5, 7) for e in (1, 6, 11)]
              + list(10.0 ** rng.uniform(-8, 4, 60)))
    multiply_alone_wrong = 0
    for s in scales:
        s32 = torch.tensor(s, dtype=torch.float32)
        want = quantize_act(x, s32).numpy()
        np.testing.assert_array_equal(k5_quantize(v, s32.item()), want, err_msg=f"scale {s}")
        with np.errstate(over="ignore"):
            alone = np.rint(np.clip(v * (np.float32(1) / np.float32(s32.item())), -127, 127))
        multiply_alone_wrong += int((alone.astype(np.int8) != want).sum())
    assert multiply_alone_wrong > 0     # the correction step is what makes them equal


# ---------------------------------------------------------------- the kernel's addressing

def _operand(smem, start, lbo, sbo, rows):
    """The [rows, 32] int8 operand a non-swizzled K-major wgmma descriptor
    reads: row r, K byte kk at start + (r // 8) * sbo + (r % 8) * 16 +
    (kk // 16) * lbo + kk % 16."""
    r = np.arange(rows)[:, None]
    kk = np.arange(32)[None, :]
    return smem[start + (r // 8) * sbo + (r % 8) * 16 + (kk // 16) * lbo + kk % 16]


def emulate_k5(xq, wq, n, h, w, c, co, k, stride, plan, rng, operand=_operand):
    """The int32 sums ``csrc/conv_int8.cu`` computes, by its own
    addressing: xq [n, h, w, c] int8 (the quantized activation), wq
    [co, c, k, k] int8.  Returns [n, oh, ow, co] int64 and how many times
    each output was written."""
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    pad, cp, cc = (k - 1) // 2, plan.cp, plan.c_chunk
    gpt, taps = cp // 16, k * k
    # the A chunks: (first channel, 16-byte groups) of each; one where resident
    chunks = [(c0, min(cc, cp - c0) // 16) for c0 in range(0, cp, cc)]
    packed = pack_int8_weight(torch.from_numpy(wq)).numpy()      # [taps * gpt, co, 16]
    _, ph_, pw_ = plan.planes
    bm, bn, wg_m, mts, a_slots = plan.bm, plan.bn, plan.wg_m, plan.m_tiles, plan.a_slots
    tiles_x, tiles_y = -(-ow // (8 * mts)), -(-oh // (8 * wg_m))
    flat_x = xq.reshape(-1, c)
    out = np.zeros((n * oh * ow, co), np.int64)
    written = np.zeros((n * oh * ow, co), np.int64)

    def tap_slots(tap):
        if k == 1:
            return 0
        dy, dx = divmod(tap, 3)
        plane = (dy % stride) * stride + dx % stride
        return plane * ph_ * pw_ + (dy // stride) * pw_ + dx // stride

    for bx in range(plan.grid[0]):
        b, rr = divmod(bx, tiles_x * tiles_y)
        oy0, ox0 = (rr // tiles_x) * 8 * wg_m, (rr % tiles_x) * 8 * mts
        in_tab = np.full(a_slots, -1)
        for s in range(a_slots):
            if k == 3:
                plane, r = divmod(s, ph_ * pw_)
                py, px = divmod(r, pw_)
                iy = oy0 * stride - pad + py * stride + plane // stride
                ix = ox0 * stride - pad + px * stride + plane % stride
                if 0 <= iy < h and 0 <= ix < w:
                    in_tab[s] = (b * h + iy) * w + ix
            elif bx * bm + s < n * oh * ow:
                nn, r = divmod(bx * bm + s, oh * ow)
                oy, ox = divmod(r, ow)
                in_tab[s] = (nn * h + oy * stride) * w + ox * stride
        out_tab = np.full(bm, -1)
        for r in range(bm):
            if k == 3:   # m64 tile m = r // 64 is sub-patch (m // mts, m % mts)
                m, q = divmod(r, 64)
                oy, ox = oy0 + (m // mts) * 8 + q // 8, ox0 + (m % mts) * 8 + q % 8
                if oy < oh and ox < ow:
                    out_tab[r] = (b * oh + oy) * ow + ox
            elif bx * bm + r < n * oh * ow:
                out_tab[r] = bx * bm + r
        # shared memory: the A tile, then bytes the kernel does not own here
        # (the ring): the phantom step reads them (or a streamed tile's groups
        # past its chunk, left from the chunk before), times a zero B
        smem = rng.randint(-128, 128, plan.smem_bytes).astype(np.int64)

        def fill(c0, groups):   # the A tile: groups of channels c0 + 16 gq ..
            for item in range(a_slots * groups):
                gq, s = divmod(item, a_slots)
                row = np.zeros(16, np.int64)
                if in_tab[s] >= 0 and c0 + 16 * gq < c:
                    vals = flat_x[in_tab[s], c0 + 16 * gq:c0 + 16 * gq + 16]
                    row[:len(vals)] = vals
                smem[item * 16:item * 16 + 16] = row

        if len(chunks) == 1:
            fill(0, gpt)
        a_lbo, a_sbo = a_slots * 16, (pw_ * 16 if k == 3 else 128)
        for by in range(plan.grid[1]):
            t0 = by * plan.tiles_per_block
            for tile in range(t0, min(t0 + plan.tiles_per_block, plan.co_tiles)):
                n0 = tile * bn
                acc = np.zeros((2, mts, 64, 128), np.int64)
                for c0, groups in chunks:
                    if len(chunks) > 1:
                        fill(c0, groups)
                    for wg in range(2):
                      wm, wn = (wg, 0) if wg_m == 2 else (0, wg)
                      for mt in range(mts):
                        m = wm * mts + mt
                        a_row0 = ((m // mts) * 8 * pw_ + (m % mts) * 8 if k == 3 else m * 64) * 16
                        for tap in range(taps):
                            for ci in range(-(-groups * 16 // K5_KC)):
                                stage = np.zeros(bn * K5_KC, np.int64)   # groups 4ci.. of the chunk
                                for q in range(4):
                                    gq = 4 * ci + q
                                    if gq < groups:
                                        rows = packed[tap * gpt + c0 // 16 + gq, n0:n0 + bn]
                                        stage[q * bn * 16:q * bn * 16 + rows.size] = \
                                            rows.reshape(-1)
                                for st in range(2):
                                    j = 2 * ci + st
                                    a = operand(smem, a_row0 + tap_slots(tap) * 16 + 2 * j * a_lbo,
                                                a_lbo, a_sbo, 64)
                                    bmat = operand(stage, wn * 128 * 16 + 2 * st * bn * 16,
                                                   bn * 16, 128, 128)
                                    acc[wg, mt] += a @ bmat.T
                for wg in range(2):
                    wm, wn = (wg, 0) if wg_m == 2 else (0, wg)
                    for mt in range(mts):
                        m = wm * mts + mt
                        for r in range(64):
                            pix = out_tab[m * 64 + r]
                            cols = np.arange(n0 + wn * 128, n0 + wn * 128 + 128)
                            keep = cols < co
                            if pix >= 0:
                                out[pix, cols[keep]] = acc[wg, mt, r, keep]
                                written[pix, cols[keep]] += 1
    return out.reshape(n, oh, ow, co), written


@pytest.mark.parametrize("shape,layout,tpb", [
    ((2, 9, 10, 32, 24, 1, 1), (2, 1), 1), ((2, 9, 10, 32, 24, 1, 2), (1, 1), 1),
    ((1, 11, 7, 130, 300, 1, 1), (1, 1), 1), ((1, 5, 6, 45, 260, 1, 1), (2, 1), 2),
    ((1, 19, 13, 130, 200, 3, 1), (2, 1), 1), ((1, 10, 9, 66, 130, 3, 1), (1, 1), 1),
    ((2, 12, 11, 48, 136, 3, 2), (2, 1), 2), ((1, 19, 17, 34, 64, 3, 2), (1, 1), 1),
    ((2, 13, 11, 40, 136, 1, 1), (2, 2), 1), ((1, 21, 19, 90, 200, 3, 1), (2, 2), 2),
    ((1, 23, 18, 50, 64, 3, 2), (2, 2), 1),
])
def test_kernel_addressing_computes_the_conv(shape, layout, tpb):
    """The emulated kernel, in each warpgroup layout with a Co split or
    none, writes every output once with the exact int8 conv of the
    quantized activation."""
    n, h, w, c, co, k, stride = shape
    rng = np.random.RandomState(sum(shape))
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    wq = rng.randint(-127, 128, (co, c, k, k)).astype(np.int8)
    plan = _plan(n, h, w, c, co, k, stride, *layout, tpb)
    got, written = emulate_k5(xq, wq, n, h, w, c, co, k, stride, plan, rng)
    want = F.conv2d(torch.from_numpy(xq).permute(0, 3, 1, 2).double(),
                    torch.from_numpy(wq).double(), stride=stride, padding=(k - 1) // 2)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).numpy().astype(np.int64))


@pytest.mark.parametrize("shape,layout,chunk,tpb", [
    ((1, 9, 10, 200, 72, 1, 1), (2, 1), 64, 1), ((2, 7, 6, 290, 37, 1, 2), (1, 1), 128, 2),
    ((1, 11, 9, 130, 40, 3, 1), (2, 1), 64, 1), ((1, 13, 12, 100, 23, 3, 2), (2, 2), 64, 1),
    ((1, 12, 10, 250, 300, 3, 1), (1, 1), 128, 1), ((1, 10, 9, 45, 129, 3, 1), (2, 1), None, 2),
])
def test_streamed_and_odd_co_addressing_computes_the_conv(shape, layout, chunk, tpb):
    """The emulated kernel with C streamed through the A tile in chunks
    (the last chunk's odd k32 step reading groups the chunk before left in
    the tile, times a zero B) and with odd Co: every output written once,
    the exact int8 conv of the quantized activation."""
    n, h, w, c, co, k, stride = shape
    rng = np.random.RandomState(sum(shape))
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    wq = rng.randint(-127, 128, (co, c, k, k)).astype(np.int8)
    plan = _plan(n, h, w, c, co, k, stride, *layout, tpb, c_chunk=chunk)
    assert plan.streamed == (chunk is not None)
    got, written = emulate_k5(xq, wq, n, h, w, c, co, k, stride, plan, rng)
    want = F.conv2d(torch.from_numpy(xq).permute(0, 3, 1, 2).double(),
                    torch.from_numpy(wq).double(), stride=stride, padding=(k - 1) // 2)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, want.permute(0, 2, 3, 1).numpy().astype(np.int64))


def test_the_emulation_sees_a_wrong_layout():
    """The emulation is not vacuous: the A tile's rows read with the
    descriptor's LBO and SBO swapped give another result."""
    n, h, w, c, co, k, stride = 1, 9, 10, 64, 128, 3, 1
    rng = np.random.RandomState(0)
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    wq = rng.randint(-127, 128, (co, c, k, k)).astype(np.int8)
    plan = _plan(n, h, w, c, co, k, stride, 2, 1, 1)
    want, _ = emulate_k5(xq, wq, n, h, w, c, co, k, stride, plan, rng)
    def swapped(smem, start, lbo, sbo, rows):   # the A tile's (64 rows) fields swapped
        return _operand(smem, start, *((sbo, lbo) if rows == 64 else (lbo, sbo)), rows)

    got, _ = emulate_k5(xq, wq, n, h, w, c, co, k, stride, plan, rng, swapped)
    assert not np.array_equal(got, want)


def test_kernel_ab_binds_the_earlier_k5():
    """``tools/kernel_ab --kernels conv_int8`` calls the earlier K5 through
    the C interface its docstring states (6 pointers, 9 ints, the stream)
    with the earlier K-major weight [Co, k*k*Cp16]."""
    import ctypes
    import re

    from ppyolo_tpu_torch.tools import kernel_ab

    sig = re.search(r"conv_int8_launch\((.*?)\)", kernel_ab.__doc__, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert params[:6] == ["x", "w", "w_scale", "s_x", "bias", "y"] and params[-1] == "stream"
    want = [ctypes.c_void_p] * 6 + [ctypes.c_int] * (len(params) - 7) + [ctypes.c_void_p]
    assert kernel_ab._EARLIER_ARGTYPES["conv_int8"] == want and len(params) == 16
    wq = torch.randint(-127, 128, (6, 130, 3, 3), dtype=torch.int8)
    e = kernel_ab._earlier_int8_weight(wq)
    assert e.shape == (6, 9 * 144) and e.is_contiguous()
    taps = e.view(6, 9, 144)
    assert torch.equal(taps[:, :, :130], wq.permute(0, 2, 3, 1).reshape(6, 9, 130))
    assert not taps[:, :, 130:].any()


def test_k5_plans_fit_recovers_the_constants_that_pick_fastest():
    """``tools/k5_plans.py --fit``: on times where the model's own picks are
    fastest, the current constants score the least total, and the search
    returns its candidates sorted by it."""
    from ppyolo_tpu_torch.tools import k5_plans

    rows = []
    for shape in [(8, 76, 76, 512, 256, 1, 1), (8, 19, 19, 512, 1024, 3, 1)]:
        pick = k5_plans.key(k5_plan(*shape))
        times = {k5_plans.key(p): [1.0 if k5_plans.key(p) == pick else 2.0, p.cost_cycles]
                 for p in ci.k5_candidates(*shape)}
        rows.append({"shape": list(shape), "convs": 2, "pick": pick, "times": times})
    out = k5_plans.fit(rows, samples=20)
    assert out[0][0] == 4.0 and [t[0] for t in out] == sorted(t[0] for t in out)
    assert k5_plans.picked_ms(rows, [getattr(ci, n) for n in k5_plans.CONSTANTS]) == 4.0
    assert k5_plans.batch_ms(rows, lambda s: k5_plan(*s)) == 4.0


def test_k5_plans_fixed_rule():
    """The rule ``--fit`` scores beside the model: BM 128 where it fits,
    else BM 64; Co split only until the blocks fill one wave."""
    from ppyolo_tpu_torch.tools.k5_plans import rule_plan

    p = rule_plan((8, 76, 76, 512, 256, 1, 1))          # 361 blocks of 128: no split
    assert (p.bm, p.bn, p.co_splits) == (128, 128, 1)
    # 23 blocks, 2 an SM: 8 splits leave 184 of 264 slots, 16 fill them
    p = rule_plan((8, 19, 19, 512, 2048, 1, 1))
    assert (p.bm, p.grid, p.blocks_per_sm) == (128, (23, 16), 2)
    p = rule_plan((8, 19, 19, 2050, 512, 1, 1))         # 128 x 2080 bytes do not fit
    assert (p.bm, p.bn) == (64, 256)

