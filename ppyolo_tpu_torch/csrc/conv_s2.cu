// K4: 3x3 conv, stride 2, pad 1, as an implicit GEMM for Hopper (sm_90a).
//
// Replaces ppyolo_tpu/ops/strided_conv_pallas.py::conv_s2_pallas (kernel body
// _kernel).  The TPU kernel splits the padded input into four row/column
// parity planes (_phase_planes) because strided VMEM slices are expensive, and
// pays a full extra HBM round trip of the input to write them.  On Hopper the
// stride is only address arithmetic, so no plane is materialised: the conv is
// one GEMM with M = N*oH*oW output pixels, N = Co and K = 9 taps x C, whose A
// tile each block gathers straight from the NHWC input.  Output pixel (y, x)
// at tap (i, j) reads input pixel (2y+i-1, 2x+j-1) as 16-byte vectors along
// C; row and column -1 read as zero (with an even H the bottom and right pad
// is never reached, but the bound is checked anyway).
//
// Bound on the H100 at the ppyolo_2x serving shapes (b8 bf16, 13.6 GFLOP a
// launch): stage3_0 [8,152,152,128] moves 59.4 MB (17.7 us at 3.35 TB/s,
// bytes), stage4_0 [8,76,76,256] 30.8 MB against 13.8 us of tensor-core work
// (operations).
//
// bf16 design (what it does about the bound):
// * The product is wgmma m64n128k16 (bf16 in, fp32 accumulators), A and B
//   both from shared memory in the 128-byte swizzle (sm90.cuh): the only
//   instruction that reaches the tensor cores' full rate on Hopper.  Two
//   consumer warpgroups, each 64 of the block's 128 output pixels x all 128
//   of its output channels.
// * K runs tap by tap (9), and inside a tap over C in chunks of 64 (one
//   128-byte swizzle row per pixel per chunk).  Each thread keeps its four A
//   rows' tap-(0,0) offsets and bounds from the start, and its position in
//   (tap, chunk) as counters, so a 16-byte load costs an add and two compares;
//   C = 16, 24 or 40 leave part of a chunk empty, which the copy zero-fills.
// * A (the gather) and B (the packed weight, K-major [Co, 9*C] from
//   pack_conv_s2_weight) both go through cp.async.cg 16 bytes at a time into
//   the swizzled slot; src-size 0 zero-fills the pad, the M and Co tails and
//   the K tail.  TMA would serve B alone (A is a gather whose rows jump at
//   image borders; TMA's im2col mode would also need a fifth descriptor per
//   launch), and the 4 x 16-byte copies per thread per chunk keep the issue
//   cost of cp.async small next to the chunk's 4 wgmma.
// * A ring of 4 stages (32 KB each: A 128 x 64 and B 128 x 64 bf16): while
//   wgmma runs on chunk k, the loads of chunks k+1 and k+2 are in flight and
//   wgmma of chunk k-1 may still run (commit_group / wait_group 1); one
//   barrier per chunk frees the stage of chunk k-2 for chunk k+2.
// * Tiles: BM = BN = 128, so the A tile is read once per Co/128 column
//   block (once at stage3_0, twice at stage4_0).  129 KB of shared memory and
//   256 threads give one block per SM: stage3_0 is 361 blocks (2.73 waves of
//   132), stage4_0 182 (1.38 waves; BN = 256 would give 91 blocks, one wave on
//   69% of the SMs, the same time).
// * Epilogue: fp32 -> bf16 once, through a shared-memory tile, 16-byte
//   stores predicated on the M and Co tails.
//
// fp32: FMA on the CUDA cores, nothing cast (on par with cuDNN in fp32).
//
// Layouts: x NHWC, y NHWC [N, oH, oW, Co] in x's dtype; bf16 weight
// [Co, 9*C] (K-major), fp32 weight [9*C, Co] (tap-major, then input channel).
// Requires C % 8 == 0, Co % 8 == 0 and 16-byte aligned pointers (checked by
// the wrapper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

struct Geom {
  int H, W, C, oH, oW, Co, M, K;  // M = N*oH*oW output pixels, K = 9*C
};

// ---- bf16: wgmma on the tensor cores, cp.async ring -------------------------

constexpr int BM = 128;                      // output pixels per block
constexpr int BN = 128;                      // output channels per block
constexpr int BK = 64;                       // GEMM depth per chunk (128 bytes)
constexpr int STAGES = 4;                    // ring depth
constexpr int THREADS = 256;                 // 2 warpgroups x 64 pixels
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_LD = BN + 8;               // epilogue tile row, bf16 elements
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + 1024-byte alignment slack
static_assert(BM * OUT_LD * 2 <= STAGES * STAGE_BYTES, "epilogue tile exceeds the ring");
static_assert(THREADS == 2 * BM && THREADS == 2 * BN, "4 rows of A and B per thread");

__global__ void __launch_bounds__(THREADS, 1)
conv_s2_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, Geom g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms on 1024-byte boundaries

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // copy role: rows row0 + 32 i (i < 4) of the A and B tiles, 16-byte chunk `chunk`
  const int row0 = tid / 8, chunk = tid % 8;

  long long a_off[4];  // element offset of the row's tap (0, 0) input pixel
  int a_iy[4], a_ix[4];
  const __nv_bfloat16* b_row[4];
  bool b_live[4];
  const int hw = g.oH * g.oW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + row0 + 32 * i;
    const bool live = p < g.M;
    const int pp = live ? p : 0;
    const int n = pp / hw, r = pp - n * hw;
    const int oy = r / g.oW, ox = r - oy * g.oW;
    a_iy[i] = live ? 2 * oy - 1 : -(1 << 30);  // a dead row fails every bound check
    a_ix[i] = 2 * ox - 1;
    a_off[i] = ((long long)(n * g.H + 2 * oy - 1) * g.W + 2 * ox - 1) * g.C;
    const int co = n0 + row0 + 32 * i;
    b_live[i] = co < g.Co;
    b_row[i] = w + (size_t)(b_live[i] ? co : 0) * g.K;
  }

  const int cchunks = (g.C + BK - 1) / BK;
  const int KT = 9 * cchunks;
  int ld_tap = 0, ld_cc = 0, ld_stage = 0;  // the next chunk to load, in order
  auto load_next = [&]() {
    const int dy = ld_tap / 3, dx = ld_tap - 3 * dy;
    const int c = ld_cc * BK + chunk * 8;
    const bool c_ok = c < g.C;
    const long long tap_off = (long long)(dy * g.W + dx) * g.C + c;
    const uint32_t sa = base + ld_stage * STAGE_BYTES, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 32 * i;
      const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
      const bool ok = c_ok && (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
      sm90::cp_async_16(sa + sm90::swz128(r, chunk), ok ? x + a_off[i] + tap_off : x,
                        ok ? 16 : 0);
      const bool okb = c_ok && b_live[i];
      sm90::cp_async_16(sb + sm90::swz128(r, chunk), okb ? b_row[i] + ld_tap * g.C + c : w,
                        okb ? 16 : 0);
    }
    if (++ld_cc == cchunks) {
      ld_cc = 0;
      ++ld_tap;
    }
    ld_stage = ld_stage == STAGES - 1 ? 0 : ld_stage + 1;
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // prologue: chunks 0 .. STAGES-3 in flight
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load_next();
    sm90::cp_async_commit();
  }
  int stage = 0;
  for (int kt = 0; kt < KT; ++kt) {
    sm90::cp_async_wait<STAGES - 3>();  // this thread's copies of chunk kt have landed
    sm90::fence_proxy_async();
    // every thread's copies of chunk kt are visible, and every warpgroup has
    // waited for its wgmma of chunk kt-2, whose stage the next load reuses
    __syncthreads();
    if (kt + STAGES - 2 < KT) load_next();
    sm90::cp_async_commit();
    const uint32_t sa = base + stage * STAGE_BYTES;
    const uint64_t da = sm90::desc_sw128(sa + wg * 64 * BK * 2);
    const uint64_t db = sm90::desc_sw128(sa + A_BYTES);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)  // k16 step: 32 bytes further in the atom
      sm90::wgmma_m64n128k16_ss(acc, da + 2 * ks, db + 2 * ks);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // chunk kt's product may run on; chunk kt-1's is done
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }
  sm90::wgmma_wait<0>();
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is dead: reuse it for the output tile

  // accumulator (row, col) -> bf16 tile [BM][OUT_LD], one rounding
  __nv_bfloat16* const out = reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw));
  const int lane = tid % 32;
  const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(out + r0 * OUT_LD + 8 * i + c0) =
        __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * OUT_LD + 8 * i + c0) =
        __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  for (int v = tid; v < BM * BN / 8; v += THREADS) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int p = p0 + r;
    if (p < g.M && n0 + c < g.Co)
      *reinterpret_cast<uint4*>(y + (size_t)p * g.Co + n0 + c) =
          *reinterpret_cast<const uint4*>(out + r * OUT_LD + c);
  }
}

// ---- fp32: FMA on the CUDA cores -------------------------------------------

// One output pixel's image base (in pixels) and the top-left input pixel of
// its 3x3 window.
struct Pix {
  size_t base;
  int iy0, ix0;
  bool live;
};

__device__ __forceinline__ Pix pixel(int p, const Geom& g) {
  Pix q;
  q.live = p < g.M;
  const int pp = q.live ? p : 0;
  const int hw = g.oH * g.oW;
  const int n = pp / hw, r = pp - n * hw;
  const int oy = r / g.oW, ox = r - oy * g.oW;
  q.base = (size_t)n * g.H * g.W;
  q.iy0 = 2 * oy - 1;
  q.ix0 = 2 * ox - 1;
  return q;
}

// Element offset in x of GEMM column k (tap k / C, channel k % C) for pixel q,
// or -1 where it reads the zero pad or lies past K.  The wrapper's C % 8 == 0
// keeps every 4-wide vector inside one tap.
__device__ __forceinline__ long long x_offset(const Pix& q, int k, const Geom& g) {
  if (!q.live || k >= g.K) return -1;
  const int tap = k / g.C, c = k - tap * g.C;
  const int iy = q.iy0 + tap / 3, ix = q.ix0 + tap % 3;
  if (iy < 0 || ix < 0 || iy >= g.H || ix >= g.W) return -1;
  return (long long)(q.base + (size_t)iy * g.W + ix) * g.C + c;
}

constexpr int FM = 64;        // output pixels per block
constexpr int FN = 64;        // output channels per block
constexpr int FK = 16;        // GEMM depth per chunk
constexpr int F_THREADS = 256;  // each thread a 4 x 4 piece

__global__ void __launch_bounds__(F_THREADS)
conv_s2_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, Geom g) {
  __shared__ __align__(16) float As[FK][FM + 4];  // transposed: [k][pixel]
  __shared__ __align__(16) float Bs[FK][FN + 4];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  // A role: pixel row ar, GEMM columns ak..ak+3; B role: row br, columns bc..bc+3
  const int ar = tid / 4, ak = (tid % 4) * 4;
  const int br = tid / 16, bc = (tid % 16) * 4;
  const Pix q = pixel(p0 + ar, g);
  const bool b_col = n0 + bc < g.Co;
  // compute role: pixels ty*4.., channels tx*4..
  const int ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < g.K; k0 += FK) {
    const long long o = x_offset(q, k0 + ak, g);
    const float4 a = o < 0 ? zero : __ldg(reinterpret_cast<const float4*>(x + o));
    As[ak + 0][ar] = a.x;
    As[ak + 1][ar] = a.y;
    As[ak + 2][ar] = a.z;
    As[ak + 3][ar] = a.w;
    const int kr = k0 + br;
    *reinterpret_cast<float4*>(&Bs[br][bc]) =
        (kr < g.K && b_col)
            ? __ldg(reinterpret_cast<const float4*>(w + (size_t)kr * g.Co + n0 + bc))
            : zero;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int c = n0 + tx * 4;
  if (c >= g.Co) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p < g.M)
      *reinterpret_cast<float4*>(y + (size_t)p * g.Co + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// Blocks of the bf16 kernel that fit one SM (cudaOccupancy...), or minus the
// CUDA error.
extern "C" int conv_s2_bf16_blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      conv_s2_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conv_s2_bf16_kernel,
                                                        THREADS, SMEM_BYTES);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// x, w and y are fp32 when is_f32, else bf16.
extern "C" int conv_s2_launch(const void* x, const void* w, void* y, int is_f32,
                              int N, int H, int W, int C, int Co, void* stream) {
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.oH = (H - 1) / 2 + 1;
  g.oW = (W - 1) / 2 + 1;
  g.Co = Co;
  g.M = N * g.oH * g.oW;
  g.K = 9 * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    dim3 grid((g.M + FM - 1) / FM, (Co + FN - 1) / FN);
    conv_s2_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), g);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv_s2_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    dim3 grid((g.M + BM - 1) / BM, (Co + BN - 1) / BN);
    conv_s2_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), g);
  }
  return static_cast<int>(cudaGetLastError());
}
