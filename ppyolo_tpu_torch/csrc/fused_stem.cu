// Fused eval-mode ResNet-vd deep stem for Hopper (sm_90a).
//
// Replaces ppyolo_tpu/ops/stem_pallas.py::fused_stem (kernel body
// _stem_kernel): conv1_1 3->32 3x3/s2, conv1_2 32->32 3x3, conv1_3 32->64 3x3
// (each with its BN folded into weight and fp32 bias, then relu, fp32
// accumulation and a bf16 round) and the 3x3/s2/p1 max-pool, in one kernel.
// The TPU kernel packs pixels into 128-lane rows to feed its MXU; here only
// the image is read and only the pooled [N, S/4, S/4, 64] map is written to
// device memory, and every intermediate row lives in shared memory.
//
// A conv position outside the conv's output range is the next conv's zero
// padding and is stored as 0, not relu(bias) (the masks of stem_pallas.py
// lines 207-211, 234-236, 248-250).  The pool then pads with 0, which equals
// -inf padding because its input is post-relu.
//
// Bound on the H100: at batch 8 x 608^2 the three convs are 42.2 GFLOP against
// ~41 MB of traffic, so the arithmetic bounds it (43 us at the bf16
// tensor-core peak).  What the design does about it:
//
// * A block owns a strip of PW = 14 pooled columns and a segment of pooled
//   rows, and walks down it.  Step t of the walk is conv1_1 rows 2t+2..2t+3,
//   conv1_2 rows 2t+1..2t+2, conv1_3 rows 2t..2t+1 and pooled row t.  Rolling
//   rings in shared memory keep the last rows of the input (16 rows) and of
//   each conv (8), so no row is computed twice inside a segment.  Only the
//   strip's side halos (29 conv1_3 columns for 28 useful, 31 of conv1_2, 33
//   of conv1_1) and a segment's three warm-up steps are recomputed: at
//   b8@608 (11 strips x 3 segments of 51 rows) 1.09x the useful work
//   weighted by FLOPs, 1.11x with the ragged last strip.
// * Warp specialisation, one barrier per stage.  In stage u warpgroup 0 runs
//   conv1_3 of step u-2; warpgroup 1 conv1_2 of step u-1 and, while its
//   products run, the last conv1_1 tile of step u and the max-pool of step
//   u-3; warpgroup 2 issues the cp.async loads of step u+1's four input rows,
//   runs conv1_1's other four tiles of step u, then waits for the loads and
//   repacks the rows.  Each phase reads only rows that earlier stages wrote,
//   so the three warpgroups run side by side and the next rows' loads are in
//   flight while they compute.
// * conv1_2 and conv1_3 are implicit GEMMs on wgmma with the full N of the
//   layer (m64n32k16, m64n64k16): M = a step's 2 rows x 31 (29) pixels,
//   padded to 64; K = 9 taps x 32 channels = 18 k16 steps.  A tap shifts the
//   A rows by one 64-byte pixel, which a swizzled shared-memory A operand
//   cannot follow, so A comes from registers: ldmatrix reads each GEMM row at
//   its own tap-shifted pixel (the rings' 32-channel pixels keep 16-byte chunk
//   c at c ^ ((pixel / 2) % 4), so the 8 rows of an ldmatrix hit 8 bank
//   groups).  B, the packed K-major weights, sits in shared memory in the
//   128-byte swizzle for the whole block.  Bias, relu, the range mask and the
//   bf16 round are applied to the accumulator registers.
// * conv1_1 runs on mma.sync m16n8k16 (M = 2 x 33 pixels in 5 m16 tiles,
//   N = 32).  The input's 6-byte pixels are repacked once, zero outside the
//   image, into 8-byte (c0, c1, c2, 0) pixels, so a kernel row ky is 3
//   neighbouring pixels = 12 contiguous values and each A-fragment register is
//   one 4-byte load; K = 3 k16 steps, one per ky.
// * 141 KB of shared memory and 384 threads (168 registers each): one block
//   per SM, 264 blocks at b8@608 (two waves of 132).
//
// Layouts: x NHWC bf16 [N, H, W, 3] (16-byte aligned); w1 fp32 [27][32]
// (HWIO flattened); w2 bf16 [32][288], w3 bf16 [64][288] (K-major: column
// tap * 32 + ci); bias fp32 [128] = b1 | b2 | b3; y NHWC bf16
// [N, S4h, S4w, 64].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int PW = 14;              // pooled columns per strip
constexpr int W3 = 2 * PW + 1;      // conv1_3 strip width (29)
constexpr int W2 = W3 + 2;          // conv1_2 (31)
constexpr int W1 = W3 + 4;          // conv1_1 (33)
constexpr int W0 = 2 * W1 + 1;      // input (67)
constexpr int THREADS = 384;        // three warpgroups
constexpr int KSTEPS = 18;          // 9 taps x 32 channels / 16
constexpr int C1_TILES = (2 * W1 + 15) / 16;  // conv1_1's m16 tiles a step (5)

constexpr int IN_ROWS = 16;         // input ring
constexpr int IN_ROW_BYTES = 432;   // 67 pixels x 6 bytes from a 16-byte boundary
constexpr int IN_BLOCKS = IN_ROW_BYTES / 16;
constexpr int ACT_ROWS = 8;         // conv rings
constexpr int C1_ROW = W1 * 64;     // 32 channels bf16 a pixel
constexpr int C2_ROW = W2 * 64;
constexpr int C3_ROW = W3 * 128;    // 64 channels
constexpr int PAD_ROW = W0 * 8;     // input ring of 4-channel pixels
constexpr int W1B_LD = 56;          // conv1_1 weight row (48 bf16 used): no bank conflicts

constexpr int B2_BYTES = 5 * 32 * 128;  // 5 atoms of 64 k (288 used) x 32 rows
constexpr int B3_BYTES = 5 * 64 * 128;
constexpr int OFF_B3 = B2_BYTES;
constexpr int OFF_C3 = OFF_B3 + B3_BYTES;
constexpr int OFF_C1 = OFF_C3 + ACT_ROWS * C3_ROW;
constexpr int OFF_C2 = OFF_C1 + ACT_ROWS * C1_ROW;
constexpr int OFF_IN = OFF_C2 + ACT_ROWS * C2_ROW;
constexpr int OFF_PAD = OFF_IN + IN_ROWS * IN_ROW_BYTES;
constexpr int OFF_W1 = OFF_PAD + IN_ROWS * PAD_ROW;
constexpr int OFF_BIAS = OFF_W1 + 32 * W1B_LD * 2;
constexpr int SMEM_BYTES = OFF_BIAS + 128 * 4 + 1024;  // + 1024-byte alignment slack
static_assert(OFF_B3 % 1024 == 0 && OFF_C3 % 16 == 0 && OFF_C1 % 16 == 0 &&
                  OFF_C2 % 16 == 0 && OFF_IN % 16 == 0 && OFF_PAD % 16 == 0 &&
                  OFF_W1 % 16 == 0,
              "shared-memory regions misaligned");
static_assert(SMEM_BYTES <= 232448, "stem block exceeds shared memory");
static_assert(IN_ROW_BYTES >= 15 + W0 * 6, "an input row from its 16-byte boundary");
static_assert(C1_TILES == 5, "conv1_1: a tile for each warp of warpgroup 2, one for warpgroup 1");

struct Geom {
  int H, W, S2h, S2w, S4h, S4w;
  int seg_rows;          // pooled rows per segment
  long long x_bytes;     // bytes of x
};

// Byte offset of input row iy's strip start (column ix0) from the 16-byte
// boundary below it (x is 16-byte aligned; only the low bits matter, so the
// arithmetic may wrap).
__device__ __forceinline__ int row_phase(int n, int iy, int H, int W, int ix0) {
  return static_cast<int>(
      ((((unsigned)n * (unsigned)H + (unsigned)iy) * (unsigned)W + (unsigned)ix0) * 6u) & 15u);
}

// Byte offset of 16-byte chunk c of pixel j in a 32-channel ring row.
__device__ __forceinline__ int act_off(int j, int c) {
  return j * 64 + ((c ^ ((j >> 1) & 3)) << 4);
}

// One conv (conv1_2 or conv1_3) of a step on the warpgroup's wgmma: output
// rows r0, r0 + 1 (ring `out`, strip width WO, NOUT channels) from the
// 32-channel ring `in` (rows r0-1 .. r0+2, strip width WO + 2), weights B at
// shared address `b` (swizzled K-major [NOUT][288]), biases `bias`.
// Positions outside [0, S2h) x [0, S2w) are stored as 0.  Outputs of conv1_3
// (NOUT = 64) go to 128-byte pixels with chunk c at c ^ (pixel % 8), those of
// conv1_2 to the 32-channel layout of act_off.  `during()` runs while the
// products are in flight.
template <int WO, int NOUT, typename F>
__device__ __forceinline__ void conv_wgmma(const Geom& g, uint32_t in,
                                           int in_row, uint32_t b, unsigned char* out,
                                           int out_row, const float* bias, int r0, int c0,
                                           F&& during) {
  const int t = threadIdx.x % 128, lane = t % 32, wq = t / 32;
  // ldmatrix role: GEMM row am (pixels past 2 x WO read pixel 0; discarded)
  const int am = 16 * wq + (lane & 15);
  const int arr = am < 2 * WO ? am / WO : 0, ajj = am < 2 * WO ? am % WO : 0;
  float acc[NOUT / 2];
#pragma unroll
  for (int e = 0; e < NOUT / 2; ++e) acc[e] = 0.f;
  const uint64_t db = sm90::desc_sw128(b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t a[KSTEPS / 2][4];
#pragma unroll
    for (int i = 0; i < KSTEPS / 2; ++i) {
      const int s = half * (KSTEPS / 2) + i;  // tap s / 2, channels 16 (s % 2)..
      const int tap = s >> 1, dy = tap / 3, dx = tap - 3 * dy;
      sm90::ldmatrix_x4(a[i], in + ((r0 - 1 + arr + dy) & (ACT_ROWS - 1)) * in_row +
                                  act_off(ajj + dx, 2 * (s & 1) + (lane >> 4)));
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int i = 0; i < KSTEPS / 2; ++i) {
      const int s = half * (KSTEPS / 2) + i;  // k16 step: atom s / 4, 32 bytes in it
      const uint64_t d = db + (uint64_t)(((s >> 2) * NOUT * 128 + (s & 3) * 32) >> 4);
      if constexpr (NOUT == 32)
        sm90::wgmma_m64n32k16_rs(acc, a[i], d);
      else
        sm90::wgmma_m64n64k16_rs(acc, a[i], d);
    }
    sm90::wgmma_commit();
  }
  during();  // the warpgroup's other work, while the products run
  sm90::wgmma_wait<0>();
  // acc[e]: row 16 wq + lane / 4 (+8 for bit 1 of e), channel 8 (e / 4) + 2 (lane % 4) (+1)
#pragma unroll
  for (int e = 0; e < NOUT / 2; e += 2) {
    const int m = 16 * wq + lane / 4 + 8 * ((e >> 1) & 1);
    const int ch = 8 * (e >> 2) + 2 * (lane & 3);
    const int rr = m / WO, jj = m - rr * WO;
    const int r = r0 + rr, c = c0 + jj;
    if (m < 2 * WO) {
      const bool inside = r >= 0 && r < g.S2h && c >= 0 && c < g.S2w;
      const __nv_bfloat162 v = inside ? __floats2bfloat162_rn(fmaxf(acc[e] + bias[ch], 0.f),
                                                              fmaxf(acc[e + 1] + bias[ch + 1], 0.f))
                                      : __floats2bfloat162_rn(0.f, 0.f);
      const int off = NOUT == 32 ? act_off(jj, ch >> 3) : jj * 128 + (((ch >> 3) ^ (jj & 7)) << 4);
      *reinterpret_cast<__nv_bfloat162*>(out + (r & (ACT_ROWS - 1)) * out_row + off +
                                         (ch & 7) * 2) = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_stem_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
                  const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ w3,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Geom g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  __nv_bfloat16* const s_w1b = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W1);
  float* const s_bias = reinterpret_cast<float*>(smem + OFF_BIAS);

  const int tid = threadIdx.x, wg = tid / 128, t128 = tid % 128;
  const int n = blockIdx.z;
  const int px0 = blockIdx.x * PW;
  const int py0 = blockIdx.y * g.seg_rows;
  const int py1 = min(py0 + g.seg_rows, g.S4h);
  if (py0 >= g.S4h) return;
  const int ix0 = 4 * px0 - 7;   // input column of ring pixel 0
  const int c1x0 = 2 * px0 - 3;  // conv1_1 column of ring pixel 0
  const char* const xb = reinterpret_cast<const char*>(x);

  // input row iy -> ring slot iy % 16, from the 16-byte boundary below the
  // strip's first pixel (rows outside the image are not loaded: reads mask)
  auto load_rows = [&](int iy_first, int nrows, int first_item, int stride) {
    for (int item = first_item; item < nrows * IN_BLOCKS; item += stride) {
      const int iy = iy_first + item / IN_BLOCKS, b = item % IN_BLOCKS;
      if (iy < 0 || iy >= g.H) continue;
      const long long first = (((long long)n * g.H + iy) * g.W + ix0) * 6;
      const long long src = (first & ~15ll) + 16 * b;
      const long long left = g.x_bytes - src;
      const int bytes = src < 0 ? 0 : (int)(left < 0 ? 0 : (left > 16 ? 16 : left));
      sm90::cp_async_16(base + OFF_IN + (iy & (IN_ROWS - 1)) * IN_ROW_BYTES + 16 * b,
                        bytes ? xb + src : xb, bytes);
    }
  };

  // raw input rows iy_first.. -> 4-channel pixels (c0, c1, c2, 0) of the
  // padded ring, zero outside the image
  auto pad_rows = [&](int iy_first, int nrows, int first_item, int stride) {
    for (int item = first_item; item < nrows * W0; item += stride) {
      const int iy = iy_first + item / W0, p = item % W0;
      const int ix = ix0 + p;
      uint2 v = make_uint2(0u, 0u);
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(
            smem + OFF_IN + (iy & (IN_ROWS - 1)) * IN_ROW_BYTES +
            row_phase(n, iy, g.H, g.W, ix0) + 6 * p);
        v = make_uint2(src[0] | ((uint32_t)src[1] << 16), src[2]);
      }
      *reinterpret_cast<uint2*>(smem + OFF_PAD + (iy & (IN_ROWS - 1)) * PAD_ROW + 8 * p) = v;
    }
  };

  // prologue: the weights (swizzled K-major, zero past k = 288), w1, biases,
  // and the first step's five input rows
  for (int item = tid; item < (32 + 64) * 40; item += THREADS) {
    const int row = item / 40, a = (item % 40) / 8, c = item % 8;
    const int k = 64 * a + 8 * c;
    const bool is2 = row < 32;
    const int r = is2 ? row : row - 32, rows = is2 ? 32 : 64;
    const __nv_bfloat16* src = (is2 ? w2 : w3) + r * 288 + k;
    const uint32_t dst = base + (is2 ? 0 : OFF_B3) + a * rows * 128 + sm90::swz128(r, c);
    sm90::cp_async_16(dst, k < 288 ? src : (is2 ? w2 : w3), k < 288 ? 16 : 0);
  }
  const int t0 = py0 - 3;  // three warm-up steps fill the rings
  load_rows(4 * t0 + 3, 5, tid, THREADS);
  sm90::cp_async_commit();
  // conv1_1's weight as bf16 [co][k], k = 16 ky + 4 kx + ci, zero for ci = 3
  // and 4 kx + ci >= 12 (its values are bf16 already): the mma B fragments
  for (int i = tid; i < 32 * 48; i += THREADS) {
    const int co = i / 48, k = i % 48, ky = k / 16, kx = (k % 16) / 4, ci = k % 4;
    s_w1b[co * W1B_LD + k] =
        __float2bfloat16(kx < 3 && ci < 3 ? w1[((ky * 3 + kx) * 3 + ci) * 32 + co] : 0.f);
  }
  if (tid < 128) s_bias[tid] = bias[tid];
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();  // the weights are read by wgmma (the async proxy)
  __syncthreads();
  pad_rows(4 * t0 + 3, 5, tid, THREADS);
  __syncthreads();

  const int lane = tid % 32, w = t128 / 32;
  const int gq = lane / 4, q = lane % 4;  // mma.sync fragment row and column pair

  // conv1_1 rows 2u+2, 2u+3 on mma.sync m16n8k16: the 2 x 33 pixels in 5 m16
  // tiles, N = 32, K = 3 k16 steps, one per kernel row ky, each the 3 x 4
  // (kx, channel) values of 3 neighbouring padded pixels (the 4
  // zero-weighted rest of the step is zeroed in A too).  One warp, one tile.
  auto conv1_1_tile = [&](int u, int tile) {
    uint32_t a[3][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment rows gq and gq + 8
      const int m = 16 * tile + gq + 8 * h;
      const int rr = m / W1, j = m - rr * W1;
      const int r = 2 * u + 2 + rr;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            smem + OFF_PAD + ((2 * r - 1 + ky) & (IN_ROWS - 1)) * PAD_ROW);
        a[ky][h] = row[4 * j + q];                       // k 2q, 2q + 1
        a[ky][2 + h] = q < 2 ? row[4 * j + 4 + q] : 0u;  // k 2q + 8, 2q + 9
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* wb = smem + OFF_W1 + ((8 * nt + gq) * W1B_LD + 2 * q) * 2;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        sm90::mma_m16n8k16(d, a[ky], *reinterpret_cast<const uint32_t*>(wb + 32 * ky),
                           *reinterpret_cast<const uint32_t*>(wb + 32 * ky + 16));
      const int ch = 8 * nt + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * tile + gq + 8 * h;
        const int rr = m / W1, j = m - rr * W1;
        const int r = 2 * u + 2 + rr, c = c1x0 + j;
        if (m < 2 * W1) {
          const bool inside = r >= 0 && r < g.S2h && c >= 0 && c < g.S2w;
          const __nv_bfloat162 v =
              inside ? __floats2bfloat162_rn(fmaxf(d[2 * h] + s_bias[ch], 0.f),
                                             fmaxf(d[2 * h + 1] + s_bias[ch + 1], 0.f))
                     : __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(smem + OFF_C1 + (r & (ACT_ROWS - 1)) * C1_ROW +
                                             act_off(j, nt) + 4 * q) = v;
        }
      }
    }
  };

  // max-pool 3x3/s2 of pooled row t: conv1_3 rows 2t-1..2t+1, strip columns
  // 2i..2i+2; item = 8 i + channel group
  auto pool = [&](int t, int item) {
    const int grp = item & 7, i = item >> 3;
    const int px = px0 + i;
    if (px >= g.S4w) return;
    float mx[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) mx[e] = 0.f;  // inputs are >= 0
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const unsigned char* row = smem + OFF_C3 + ((2 * t - 1 + dy) & (ACT_ROWS - 1)) * C3_ROW;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int jj = 2 * i + dx;
        const uint4 raw4 =
            *reinterpret_cast<const uint4*>(row + jj * 128 + ((grp ^ (jj & 7)) << 4));
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw4);
#pragma unroll
        for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], __bfloat162float(v[e]));
      }
    }
    uint4 out;
    __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e) pk[e] = __float2bfloat16(mx[e]);
    *reinterpret_cast<uint4*>(y + (((size_t)n * g.S4h + t) * g.S4w + px) * 64 + grp * 8) = out;
  };

  // stage u: conv1_3 of step u-2 (warpgroup 0); conv1_2 of step u-1 and,
  // while its products run, conv1_1's last tile of step u and the pool of
  // step u-3 (warpgroup 1); the loads of step u+1's input rows and conv1_1's
  // first four tiles of step u (warpgroup 2)
  for (int u = t0; u < py1 + 3; ++u) {
    if (wg == 0) {
      const int t = u - 2;
      if (t >= py0 - 1 && t < py1)
        conv_wgmma<W3, 64>(g, base + OFF_C2, C2_ROW, base + OFF_B3, smem + OFF_C3, C3_ROW,
                           s_bias + 64, 2 * t, 2 * px0 - 1, [] {});
    } else if (wg == 1) {
      const int t = u - 1;
      auto side = [&] {
        if (u < py1 && w == 0) conv1_1_tile(u, C1_TILES - 1);
        if (u - 3 >= py0 && t128 < PW * 8) pool(u - 3, t128);
      };
      if (t >= py0 - 2 && t < py1)
        conv_wgmma<W2, 32>(g, base + OFF_C1, C1_ROW, base, smem + OFF_C2, C2_ROW,
                           s_bias + 32, 2 * t + 1, 2 * px0 - 2, side);
      else
        side();
    } else {
      if (u + 1 < py1) load_rows(4 * u + 8, 4, t128, 128);  // the next step's rows
      sm90::cp_async_commit();
      if (u < py1) conv1_1_tile(u, w);
      sm90::cp_async_wait<0>();
      sm90::named_barrier(1, 128);  // the next step's rows have landed, all of them
      if (u + 1 < py1) pad_rows(4 * u + 8, 4, t128, 128);
    }
    __syncthreads();
  }
}

}  // namespace

// Blocks of the kernel that fit one SM (cudaOccupancy...), or minus the CUDA
// error.
extern "C" int fused_stem_blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_stem_kernel, THREADS,
                                                        SMEM_BYTES);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

extern "C" int fused_stem_launch(const void* x, const void* w1, const void* w2,
                                 const void* w3, const void* bias, void* y, int N, int H,
                                 int W, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geom g;
  g.H = H;
  g.W = W;
  g.S2h = (H - 1) / 2 + 1;
  g.S2w = (W - 1) / 2 + 1;
  g.S4h = (g.S2h - 1) / 2 + 1;
  g.S4w = (g.S2w - 1) / 2 + 1;
  g.x_bytes = (long long)N * H * W * 3 * 2;
  // enough row segments per strip for two waves of blocks, each segment at
  // least 8 pooled rows (a segment pays three warm-up steps)
  const int strips = (g.S4w + PW - 1) / PW;
  const int want = (2 * sms + strips * N - 1) / (strips * N);
  const int most = (g.S4h + 7) / 8;
  const int segs = want < 1 ? 1 : (want > most ? most : want);
  g.seg_rows = (g.S4h + segs - 1) / segs;
  dim3 grid(strips, (g.S4h + g.seg_rows - 1) / g.seg_rows, N);
  fused_stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), g);
  return static_cast<int>(cudaGetLastError());
}
