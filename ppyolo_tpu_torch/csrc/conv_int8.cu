// K5: int8 conv of the int8 serving mode (k in {1, 3}, stride in {1, 2}, pad
// (k-1)/2) as an implicit GEMM on wgmma s8 for Hopper (sm_90a).
//
// Replaces the int8 lax.conv_general_dilated of
// ppyolo_tpu/ops/conv.py::quantized_conv2d.  No Pallas kernel stands behind it:
// XLA computes that conv in the JAX package.  PyTorch has no int8 conv on the
// card, torch._int_mm takes only plain GEMMs with K a multiple of 8 (the head's
// CoordConv inputs have C = 130 ... 2050, C = 2 mod 8), and an im2col would move
// 9x the bytes on the 3x3s, so the conv is written by hand.
//
// The GEMM: M = N*oH*oW output pixels, N = Co, K = k*k taps x C.  Output pixel
// p at tap (dy, dx) reads input pixel (oy*stride + dy - pad, ox*stride + dx -
// pad); outside the image it reads 0.
//
// Bound on the H100 (ppyolo_2x@608 b8): the 65 convs do 694 GOP against
// 1,979 TOP/s of int8 tensor cores, and read 1.25 GB of bf16 activations and
// write 1.00 GB at 3.35 TB/s: most are bound by bytes.  What held the first
// form (mma.sync, quantize on load) at 17x its bound: each activation was
// quantized, with an IEEE division, once per tap and once per 128-channel
// column block.  This form:
//
// * Quantizes each input element once per block that reads it.  A block owns
//   BM output pixels and loads the input they read once, quantized into an int8
//   A tile resident in shared memory for the whole block:
//     - 1x1 ("linear"): BM pixels x all of C;
//     - 3x3 ("halo"): a patch of 8 * WG_M x 8 * MT output pixels and its input
//       halo, which the nine taps read as shifted windows.  Under stride 2 the
//       halo is stored as four parity planes, so a tap's 8 output columns
//       still read 8 consecutive slots.
//   The block walks its share of Co (tiles_per_block tiles of BN channels)
//   with that tile resident; the host plan (ops/conv_int8.py::k5_plan)
//   splits Co across blocks only as far as filling the card pays.
//   Where no resident tile fits shared memory (C past K5_MAX_C: 2272 for a
//   1x1, 1440 for a 3x3 at stride 1, 416 at stride 2), the plan streams C:
//   the A tile holds one chunk of Cc channels (a multiple of 64) and, for
//   each Co tile, the block quantizes chunk after chunk into it (the same
//   halo for all nine taps), running each chunk's products into the same
//   accumulators: each element quantized once per Co tile it serves.  A warp
//   quantizes 8 slots x 4 groups at a time: 8 runs of 128 contiguous bytes.
//   Quantization is clip(rint(RN(f32(x) / s_x)), -127, 127).  The quotient
//   is correctly rounded by a reciprocal multiply and one exact FMA
//   correction (Markstein); __fdiv_rn, which cost ~2 ms a b8@608 batch,
//   remains only for a scale outside [2^-64, 2^64].  The clip is in fp32 and
//   the round half to even an add of 1.5 * 2^23 (the int8 is the low byte
//   of the sum), so no conversion unit.
// * The A tile is wgmma's non-swizzled K-major layout: slot s (a pixel) and
//   16-channel group g at byte (g * a_slots + s) * 16, so 8 consecutive slots
//   form one 8 x 16-byte core matrix.  A tap's operand is the same descriptor
//   moved by its slot offset x 16 bytes; LBO (next group along K) = a_slots *
//   16, SBO (next 8 output pixels) = 128 (linear) or plane_w * 16 (halo).
// * The products are wgmma m64n128k32 s8 x s8 -> s32, A and B from shared
//   memory.  Two warpgroups in one of three layouts: both on BN = 128
//   channels with one m64 tile each (BM = 128) or two (BM = 256, half the
//   weight's L2 traffic per product, one block an SM by registers), or
//   splitting BN = 256 over BM = 64 (the 1x1s whose C is too wide for 128
//   rows); the plan picks one per shape.  The weight streams through a
//   5-stage ring of 64-byte K chunks by cp.async (the next chunks in flight
//   while wgmma runs), from pack_int8_weight's group-major [k*k*Cp/16, Co,
//   16] int8, so a chunk is BN consecutive 16-byte rows per group: coalesced
//   and conflict-free.  Cp = C rounded up to 32; a tap with an odd number of
//   k32 steps issues its last chunk's second step on a zero-filled B (its A
//   reads past the tile, inside the block's shared memory).
// * Epilogue from the accumulators, with each Co tile's s_x * w_scale[o] and
//   bias staged in shared memory at the tile's start (two tiles' worth, so
//   the next tile's never overwrites what a slow warp still reads): y =
//   bf16_rn(f32_rn(acc) * (s_x * w_scale[o])) (+ bias, added in fp32 and
//   rounded to bf16 once more), the JAX order, every step correctly rounded
//   (no FMA contraction), so the result is bit-equal to the plain version
//   (quantized_conv2d_plain); the int32 sum is exact in any order.
//
// Layouts: x NHWC bf16, y NHWC [N, oH, oW, Co] bf16, w_scale [Co] fp32, s_x one
// fp32 on the device, bias [Co] bf16 or null.  Any Co: an even Co stores
// column pairs as bf16x2, an odd one column by column.  Requires the packed
// weight 16-byte aligned (checked by the wrapper).  The wrapper passes the
// plan: the layout, the Co tiles a block walks, the A tile's slots, halo
// planes and channels, the grid and the dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;  // two warpgroups
constexpr int WN = 128;       // output channels of one warpgroup's wgmma
constexpr int KC = 64;        // K bytes of one ring stage (two k32 steps)
constexpr int STAGES = 5;     // ring depth: 3 chunks in flight ahead of the one wgmma reads
constexpr int QU = 4;         // A-tile units a warp loads before it quantizes them
constexpr int WS = 8, WG = 4;  // a warp's unit: WS slots x WG 16-channel groups
constexpr int SMEM_MAX = 232448;  // 227 KB: the most a block may opt in to

struct Geom {
  int H, W, C, Cp, Co, M;  // M = N*oH*oW output pixels; Cp = C rounded up to 32
  int Cc, chunks;            // channels of the A tile (Cp, or a chunk of 64 * j), chunks of Cp
  int oH, oW, k, stride, pad;
  int tiles_per_block, co_tiles;
  int plane_h, plane_w;      // halo: the A tile's parity planes (1 plane at stride 1)
  int a_slots;               // pixel slots of the A tile
  int tiles_x, tiles_y;      // halo: patches per image along x and y
  int ring_off, tab_off, ep_off;  // shared-memory layout after the A tile
};

// s_x's range where quant1 divides by a reciprocal multiply and one exact
// FMA correction (Markstein): r = RN(1/s) and the correction are then normal.
constexpr float RCP_LO = 5.421010862e-20f, RCP_HI = 1.844674407e19f;  // 2^-64, 2^64

// A bf16 in the high half of `bits_hi` (the low half 0) -> its int8 in the
// low byte of the result: clip(rint(RN(v / s)), -127, 127).  EXACT: a
// correctly rounded division.  Otherwise q0 = RN(v * r) with r = RN(1/s),
// then RN(q0 + r * (v - q0 * s)), the remainder exact by FMA, which is the
// correctly rounded quotient (Markstein) wherever it can reach the int8
// range (|q0| < 256; past it the clip decides and q0's sign suffices).
template <bool EXACT>
__device__ __forceinline__ uint32_t quant1(uint32_t bits_hi, float s, float r) {
  const float v = __uint_as_float(bits_hi);
  float t;
  if (EXACT) {
    t = __fdiv_rn(v, s);
  } else {
    const float q0 = __fmul_rn(v, r);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);
    t = fabsf(q0) < 256.f ? q1 : q0;
  }
  t = fminf(fmaxf(t, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));  // 1.5 * 2^23: rint, half to even
}

// Two bf16 pairs (channel order: lo of a, hi of a, lo of b, hi of b) -> 4 int8.
template <bool EXACT>
__device__ __forceinline__ uint32_t quant4(uint32_t a, uint32_t b, float s, float r) {
  const uint32_t q0 = quant1<EXACT>(a << 16, s, r), q1 = quant1<EXACT>(a & 0xffff0000u, s, r);
  const uint32_t q2 = quant1<EXACT>(b << 16, s, r), q3 = quant1<EXACT>(b & 0xffff0000u, s, r);
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// Channels c .. c+15 of the pixel whose channel 0 is at `src`, as 8 bf16
// pairs; 0 where c + j >= C.  vec: channels one load reads (8: C % 8 == 0,
// 2: C even, 1).
__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ src, int c, int C,
                                       int vec, uint32_t (&h)[8]) {
  if (vec == 8) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (c < C) a = __ldg(reinterpret_cast<const uint4*>(src + c));
    if (c + 8 < C) b = __ldg(reinterpret_cast<const uint4*>(src + c + 8));
    h[0] = a.x, h[1] = a.y, h[2] = a.z, h[3] = a.w;
    h[4] = b.x, h[5] = b.y, h[6] = b.z, h[7] = b.w;
    return;
  }
  const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cj = c + 2 * j;
    if (vec == 2) {
      h[j] = cj < C ? __ldg(reinterpret_cast<const unsigned int*>(p + cj)) : 0u;
    } else {
      const uint32_t lo = cj < C ? static_cast<uint32_t>(__ldg(p + cj)) : 0u;
      const uint32_t hi = cj + 1 < C ? static_cast<uint32_t>(__ldg(p + cj + 1)) : 0u;
      h[j] = lo | (hi << 16);
    }
  }
}

// The A tile: item (slot s, group gq) at byte (gq * a_slots + s) * 16 of
// `tile`, the 16 channels c0 + 16 gq .. of slot s's input pixel (in_tab[s],
// or -1 for zeros) quantized (r = RN(1 / s_x)), for the gpt groups of the
// chunk from channel c0.  A warp takes WS slots x WG
// groups at a time (lane l: slot l / WG, group l % WG), so it reads WS runs
// of WG * 32 contiguous bytes and stores WG runs of WS * 16; it issues the
// loads of QU such units before it quantizes any of them.
template <bool EXACT>
__device__ __forceinline__ void quantize_tile(const __nv_bfloat16* __restrict__ x, float sx,
                                              float rx, const Geom& g, int vec, int c0,
                                              int gpt, const int* in_tab,
                                              unsigned char* tile) {
  const int nsb = (g.a_slots + WS - 1) / WS, units = nsb * ((gpt + WG - 1) / WG);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int u0 = warp; u0 < units; u0 += QU * (THREADS / 32)) {
    uint32_t h[QU][8];
    int at[QU];  // the item's byte / 16 in the tile, or -1
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int unit = u0 + u * (THREADS / 32);
      const int gb = unit / nsb, sb = unit - gb * nsb;
      const int s = sb * WS + lane / WG, gq = gb * WG + lane % WG;
      const bool live = unit < units && s < g.a_slots && gq < gpt;
      at[u] = live ? gq * g.a_slots + s : -1;
      const int pix = live ? in_tab[s] : -1;
      if (pix >= 0 && c0 + 16 * gq < g.C) {
        load16(x + (long long)pix * g.C, c0 + 16 * gq, g.C, vec, h[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) h[u][j] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      if (at[u] < 0) continue;
      uint4 q;
      q.x = quant4<EXACT>(h[u][0], h[u][1], sx, rx);
      q.y = quant4<EXACT>(h[u][2], h[u][3], sx, rx);
      q.z = quant4<EXACT>(h[u][4], h[u][5], sx, rx);
      q.w = quant4<EXACT>(h[u][6], h[u][7], sx, rx);
      *reinterpret_cast<uint4*>(tile + (size_t)at[u] * 16) = q;
    }
  }
}

// One Co tile's accumulators to y: bf16_rn(f32_rn(acc) * (s_x * w_scale[o]))
// (+ bias, added in fp32 and rounded to bf16 once more), the JAX order, each
// step correctly rounded; `ep` holds the tile's scales, then its biases.
// PAIRS: an even Co, each lane's two columns stored as one bf16 pair; an odd
// Co leaves a pixel's row 2-byte aligned, so its columns go one by one (two
// instantiations: the branch inside the loop cost the even case 2%).
template <int MT, int BN, bool PAIRS>
__device__ __forceinline__ void store_tile(const int (&acc)[MT][64], const float* ep, int col0,
                                           int co_base, const int (&out0)[MT],
                                           const int (&out1)[MT], bool has_bias,
                                           __nv_bfloat16* __restrict__ y, int Co) {
#pragma unroll
  for (int i = 0; i < WN / 8; ++i) {
    const int co = co_base + 8 * i;
    if (co >= Co) continue;
    const float2 sc = *reinterpret_cast<const float2*>(ep + col0 + 8 * i);
    const float2 bs = *reinterpret_cast<const float2*>(ep + BN + col0 + 8 * i);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pix = hh ? out1[mt] : out0[mt];
        if (pix < 0) continue;
        __nv_bfloat16 v0 =
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[mt][4 * i + 2 * hh]), sc.x));
        __nv_bfloat16 v1 =
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[mt][4 * i + 2 * hh + 1]), sc.y));
        if (has_bias) {
          v0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v0), bs.x));
          v1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v1), bs.y));
        }
        __nv_bfloat16* const dst = y + (size_t)pix * Co + co;
        if (PAIRS) {
          __nv_bfloat162 pair;
          pair.x = v0;
          pair.y = v1;
          *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
        } else {
          dst[0] = v0;
          if (co + 1 < Co) dst[1] = v1;
        }
      }
    }
  }
}

// Slot offset of tap `tap` from a row's tap-(0, 0) slot in the A tile.
__device__ __forceinline__ int tap_slots(int tap, const Geom& g) {
  if (g.k == 1) return 0;
  const int dy = tap / 3, dx = tap - 3 * dy;
  const int plane = (dy % g.stride) * g.stride + dx % g.stride;
  return plane * g.plane_h * g.plane_w + (dy / g.stride) * g.plane_w + dx / g.stride;
}

// WG_M warpgroups along M (2: both on BN = 128 channels; 1: the two split
// BN = 256), each MT m64 tiles deep: BM = 64 * WG_M * MT output pixels.  A
// 3x3 block's patch is 8 * WG_M rows x 8 * MT columns, its m64 tiles 8 x 8
// sub-patches; a 1x1 block's pixels are consecutive.  STREAM: the A tile
// holds a chunk of g.Cc channels at a time (C past a resident tile); the
// resident kernels are built without the chunk loop, which would cost them
// registers.
template <int WG_M, int MT, bool STREAM>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 2 : 1)
conv_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ s_x_ptr,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                 Geom g, int vec) {
  constexpr int BM = 64 * WG_M * MT;
  constexpr int BN = WN * (2 / WG_M);
  constexpr int STAGE_BYTES = BN * KC;
  constexpr int B_COPIES = BN * (KC / 16) / THREADS;  // 16-byte copies a thread, a chunk
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* const gbase = smem_raw + (base - raw);
  int* const in_tab = reinterpret_cast<int*>(gbase + g.tab_off);  // slot -> input pixel or -1
  int* const out_tab = in_tab + g.a_slots;                        // row -> output pixel or -1

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wm = WG_M == 2 ? wg : 0, wn = WG_M == 2 ? 0 : wg;
  const int tile0 = blockIdx.y * g.tiles_per_block;
  const int ntiles = min(g.tiles_per_block, g.co_tiles - tile0);
  const int gpt = g.Cp / 16;                 // 16-byte groups of a tap
  const int taps = g.k * g.k;
  // groups and ring chunks of a tap in an A chunk: every A chunk but the last
  // holds Cc channels (all of Cp where the A tile is resident)
  const int chunks = STREAM ? g.chunks : 1;
  const int cgp_full = STREAM ? g.Cc / 16 : gpt;
  const int cgp_last = STREAM ? (g.Cp - (chunks - 1) * g.Cc) / 16 : gpt;
  const int cpt_full = (cgp_full * 16 + KC - 1) / KC;
  const int cpt_last = (cgp_last * 16 + KC - 1) / KC;
  const int KT = ntiles * taps * ((chunks - 1) * cpt_full + cpt_last);

  // ---- the weight ring: chunk (tile, A chunk ch, tap, c) is groups 4c .. 4c+3
  // of the tap's share of A chunk ch
  int ld_tile = 0, ld_ch = 0, ld_tap = 0, ld_c = 0, ld_stage = 0;
  auto load_next = [&]() {
    const uint32_t sb = base + g.ring_off + ld_stage * STAGE_BYTES;
    const int n0 = (tile0 + ld_tile) * BN;
    const bool last = !STREAM || ld_ch == chunks - 1;
    const int cgp = last ? cgp_last : cgp_full;
    const int g0 = ld_tap * gpt + (STREAM ? ld_ch * cgp_full : 0);
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) {
      const int j = tid + i * THREADS;
      const int q = j / BN, row = j % BN;
      const int gq = 4 * ld_c + q, co = n0 + row;
      const bool ok = gq < cgp && co < g.Co;
      const int8_t* src = w + ((size_t)(g0 + gq) * g.Co + co) * 16;
      sm90::cp_async_16(sb + (q * BN + row) * 16, ok ? src : w, ok ? 16 : 0);
    }
    if (++ld_c == (last ? cpt_last : cpt_full)) {
      ld_c = 0;
      if (++ld_tap == taps) {
        ld_tap = 0;
        if (!STREAM || ++ld_ch == chunks) {
          ld_ch = 0;
          ++ld_tile;
        }
      }
    }
    ld_stage = ld_stage == STAGES - 1 ? 0 : ld_stage + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {  // in flight while the A tile is quantized
    if (s < KT) load_next();
    sm90::cp_async_commit();
  }

  // ---- the block's pixels: A slots and output rows
  const int bx = blockIdx.x;
  int n = 0, oy0 = 0, ox0 = 0;
  const int patches = g.tiles_x * g.tiles_y;
  if (g.k == 3) {
    n = bx / patches;
    const int r = bx - n * patches;
    oy0 = (r / g.tiles_x) * 8 * WG_M;
    ox0 = (r % g.tiles_x) * 8 * MT;
  }
  const int ohw = g.oH * g.oW;
  for (int s = tid; s < g.a_slots; s += THREADS) {
    int pix = -1;
    if (g.k == 3) {
      const int pp = g.plane_h * g.plane_w;
      const int plane = s / pp, r = s - plane * pp;
      const int py = r / g.plane_w, px = r - py * g.plane_w;
      const int iy = oy0 * g.stride - g.pad + py * g.stride + plane / g.stride;
      const int ix = ox0 * g.stride - g.pad + px * g.stride + plane % g.stride;
      if ((unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W)
        pix = (n * g.H + iy) * g.W + ix;
    } else {
      const int p = bx * BM + s;
      if (p < g.M) {
        const int nn = p / ohw, r = p - nn * ohw;
        const int oy = r / g.oW, ox = r - oy * g.oW;
        pix = (nn * g.H + oy * g.stride) * g.W + ox * g.stride;
      }
    }
    in_tab[s] = pix;
  }
  for (int r = tid; r < BM; r += THREADS) {
    int pix = -1;
    if (g.k == 3) {  // m64 tile r / 64 is sub-patch (m / MT, m % MT)
      const int m = r / 64, rr = r % 64;
      const int oy = oy0 + (m / MT) * 8 + rr / 8, ox = ox0 + (m % MT) * 8 + rr % 8;
      if (oy < g.oH && ox < g.oW) pix = (n * g.oH + oy) * g.oW + ox;
    } else if (bx * BM + r < g.M) {
      pix = bx * BM + r;
    }
    out_tab[r] = pix;
  }
  __syncthreads();

  // ---- the A tile: quantized once where it holds all of C (resident);
  // streamed, chunk by chunk in the loop below
  const float sx = *s_x_ptr;
  const bool exact = !(sx >= RCP_LO && sx <= RCP_HI);
  const float rx = exact ? 0.f : __frcp_rn(sx);
  auto quantize = [&](int c0, int groups) {
    if (exact)
      quantize_tile<true>(x, sx, rx, g, vec, c0, groups, in_tab, gbase);
    else
      quantize_tile<false>(x, sx, rx, g, vec, c0, groups, in_tab, gbase);
    sm90::fence_proxy_async();  // the A tile's generic stores, visible to wgmma
  };
  if (!STREAM) quantize(0, gpt);

  // ---- products
  const uint32_t a_lbo = g.a_slots * 16;
  const uint32_t a_sbo = g.k == 3 ? g.plane_w * 16 : 128;
  const int lane = tid % 32;
  uint32_t a_row0[MT];  // each m64 tile's A start at tap (0, 0)
  int out0[MT], out1[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = wm * MT + mt;
    a_row0[mt] = base + (g.k == 3 ? (m / MT) * 8 * g.plane_w + (m % MT) * 8 : m * 64) * 16;
    const int r0 = m * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    out0[mt] = out_tab[r0];
    out1[mt] = out_tab[r0 + 8];
  }

  int acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0;
  int stage = 0, kt = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    for (int ch = 0; ch < chunks; ++ch) {
      const bool last = ch == chunks - 1;
      // streamed: A chunk ch over the one before, once both warpgroups' wgmmas have read it
      if (STREAM) {
        sm90::wgmma_wait<0>();
        __syncthreads();
        quantize(ch * g.Cc, last ? cgp_last : cgp_full);
      }
      const int cpt = last ? cpt_last : cpt_full;
      for (int tap = 0; tap < taps; ++tap) {
        const uint32_t a_tap = tap_slots(tap, g) * 16;  // this tap's A offset
        for (int c = 0; c < cpt; ++c, ++kt) {
          // the tile's s_x * w_scale and bias, for its epilogue
          if (ch == 0 && tap == 0 && c == 0) {
            float* const ep = reinterpret_cast<float*>(gbase + g.ep_off) + (tile & 1) * 2 * BN;
            for (int j = tid; j < BN; j += THREADS) {
              const int co = (tile0 + tile) * BN + j;
              ep[j] = co < g.Co ? __fmul_rn(sx, w_scale[co]) : 0.f;
              ep[BN + j] = co < g.Co && bias != nullptr ? __bfloat162float(bias[co]) : 0.f;
            }
          }
          sm90::cp_async_wait<STAGES - 3>();  // this thread's copies of chunk kt have landed
          sm90::fence_proxy_async();
          // every thread's copies of chunk kt are visible, and both warpgroups
          // have waited for their wgmma of chunk kt-2, whose stage the next load reuses
          __syncthreads();
          if (kt + STAGES - 2 < KT) load_next();
          sm90::cp_async_commit();
          const uint32_t sb = base + g.ring_off + stage * STAGE_BYTES + wn * WN * 16;
          sm90::wgmma_fence();
#pragma unroll
          for (int st = 0; st < 2; ++st) {  // k32 step 2c + st of the tap: 2 groups further
            const uint32_t ka = a_tap + 2 * (2 * c + st) * a_lbo;
            const uint64_t db = sm90::desc_noswz(sb + 2 * st * BN * 16, BN * 16, 128);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              sm90::wgmma_m64n128k32_s8_ss(acc[mt], sm90::desc_noswz(a_row0[mt] + ka, a_lbo, a_sbo),
                                           db, (ch | tap | c | st) != 0);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // chunk kt's product may run on; chunk kt-1's is done
          stage = stage == STAGES - 1 ? 0 : stage + 1;
        }
      }
    }
    // the tile's accumulators to y
    sm90::wgmma_wait<0>();
    const float* const ep =
        reinterpret_cast<const float*>(gbase + g.ep_off) + (tile & 1) * 2 * BN;
    const int col0 = wn * WN + 2 * (lane % 4);
    const int co_base = (tile0 + tile) * BN + col0;
    if (g.Co % 2)
      store_tile<MT, BN, false>(acc, ep, col0, co_base, out0, out1, bias != nullptr, y, g.Co);
    else
      store_tile<MT, BN, true>(acc, ep, col0, co_base, out0, out1, bias != nullptr, y, g.Co);
  }
  sm90::cp_async_wait<0>();
}

using KernelFn = void (*)(const __nv_bfloat16*, const int8_t*, const float*, const float*,
                          const __nv_bfloat16*, __nv_bfloat16*, Geom, int);

template <int WG_M, int MT>
KernelFn layout_kernel(bool stream, cudaError_t* err) {
  static const cudaError_t resident = cudaFuncSetAttribute(
      conv_int8_kernel<WG_M, MT, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  static const cudaError_t streamed = cudaFuncSetAttribute(
      conv_int8_kernel<WG_M, MT, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  *err = stream ? streamed : resident;
  return stream ? conv_int8_kernel<WG_M, MT, true> : conv_int8_kernel<WG_M, MT, false>;
}

// The kernel of a layout, (wg_m, m_tiles) in {(2, 1), (1, 1), (2, 2)}, resident
// or streamed; null for another layout.
KernelFn kernel_of(int wg_m, int m_tiles, bool stream, cudaError_t* err) {
  if (wg_m == 2 && m_tiles == 1) return layout_kernel<2, 1>(stream, err);
  if (wg_m == 1 && m_tiles == 1) return layout_kernel<1, 1>(stream, err);
  if (wg_m == 2 && m_tiles == 2) return layout_kernel<2, 2>(stream, err);
  *err = cudaErrorInvalidValue;
  return nullptr;
}

}  // namespace

// Blocks of the kernel with `wg_m` warpgroups along M of `m_tiles` m64 tiles
// each, resident or `streamed`, and `smem_bytes` of dynamic shared memory that
// fit one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// CUDA error.
extern "C" int conv_int8_blocks_per_sm(int wg_m, int m_tiles, int streamed, int smem_bytes) {
  cudaError_t err;
  const KernelFn fn = kernel_of(wg_m, m_tiles, streamed != 0, &err);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem_bytes);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// bias may be null.  The plan (ops/conv_int8.py::k5_plan): wg_m and m_tiles
// (the layout: (2, 1), (1, 1) or (2, 2)), tiles_per_block (Co tiles of
// 256 / wg_m channels a block walks), plane_h and plane_w (3x3: the A tile's
// parity planes), a_slots (pixel slots of the A tile), c_chunk (channels of
// the A tile: Cp where it holds all of C, else a multiple of 64 below Cp, the
// streamed layout), the grid (grid_m pixel blocks x grid_n Co splits) and
// smem_bytes.  Returns the launch's CUDA error (0 on success).
extern "C" int conv_int8_launch(const void* x, const void* w, const void* w_scale,
                                const void* s_x, const void* bias, void* y, int N, int H, int W,
                                int C, int Co, int k, int stride, int wg_m, int m_tiles,
                                int tiles_per_block, int plane_h, int plane_w, int a_slots,
                                int c_chunk, int grid_m, int grid_n, int smem_bytes,
                                void* stream) {
  const int Cp = (C + 31) / 32 * 32;
  cudaError_t err;
  const KernelFn fn = kernel_of(wg_m, m_tiles, c_chunk < Cp, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Cp = Cp;
  g.Cc = c_chunk;
  g.chunks = (g.Cp + c_chunk - 1) / max(c_chunk, 1);
  g.Co = Co;
  g.k = k;
  g.stride = stride;
  g.pad = (k - 1) / 2;
  g.oH = (H - 1) / stride + 1;
  g.oW = (W - 1) / stride + 1;
  g.M = N * g.oH * g.oW;
  const int bn = WN * (2 / wg_m), bm = 64 * wg_m * m_tiles;
  g.co_tiles = (Co + bn - 1) / bn;
  g.tiles_per_block = tiles_per_block;
  g.plane_h = plane_h;
  g.plane_w = plane_w;
  g.a_slots = a_slots;
  g.tiles_x = (g.oW + 8 * m_tiles - 1) / (8 * m_tiles);
  g.tiles_y = (g.oH + 8 * wg_m - 1) / (8 * wg_m);
  if (c_chunk < 32 || c_chunk > g.Cp || (c_chunk < g.Cp && c_chunk % KC))
    return static_cast<int>(cudaErrorInvalidValue);
  g.ring_off = (a_slots * g.Cc + 127) / 128 * 128;
  g.tab_off = g.ring_off + STAGES * bn * KC;
  g.ep_off = g.tab_off + (4 * (a_slots + bm) + 15) / 16 * 16;
  int need = g.ep_off + 16 * bn + 128;  // + base alignment
  // the phantom step past a resident tile (a streamed chunk's stays inside its tile)
  if (g.chunks == 1 && g.Cp % KC) need = max(need, g.ring_off + 2 * a_slots * 16 + 128);
  if (smem_bytes < need || smem_bytes > SMEM_MAX || grid_n * tiles_per_block < g.co_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = C % 8 == 0 ? 8 : C % 2 == 0 ? 2 : 1;
  fn<<<dim3(grid_m, grid_n), THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(s_x),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), g, vec);
  return static_cast<int>(cudaGetLastError());
}
