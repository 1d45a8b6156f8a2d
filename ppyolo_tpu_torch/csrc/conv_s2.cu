// K4: 3x3 conv, stride 2, pad 1, as an implicit GEMM for Hopper (sm_90a).
//
// Replaces ppyolo_tpu/ops/strided_conv_pallas.py::conv_s2_pallas (kernel body
// _kernel).  The TPU kernel splits the padded input into four row/column
// parity planes (_phase_planes) because strided VMEM slices are expensive, and
// pays a full extra HBM round trip of the input to write them.  On Hopper the
// stride is only address arithmetic, so no plane is materialised: the conv is
// one GEMM with M = N*oH*oW output pixels, N = Co and K = 9 taps x C, whose A
// tile each block loads straight from the NHWC input.  Output pixel (y, x) at
// tap (i, j) reads input pixel (2y+i-1, 2x+j-1) as 16-byte vectors along C;
// row and column -1 read as zero (with an even H the bottom and right pad is
// never reached, but the bound is checked anyway).  The B tile comes from the
// packed weight [9*C, Co] (tap-major, then input channel).
//
// bf16: wmma 16x16x16 on the tensor cores, fp32 accumulation, one bf16 store
// (the Pallas kernel's fp32 accumulator cast to x's dtype).  fp32: FMA on the
// CUDA cores, nothing cast.
//
// Bound on the H100 at the ppyolo_2x serving shapes (b8 bf16, 13.6 GFLOP a
// launch): stage3_0 [8,152,152,128] moves 59.4 MB (17.7 us at 3.35 TB/s,
// bytes), stage4_0 [8,76,76,256] 30.8 MB against 13.8 us of tensor-core work
// (operations).  This first version is simple rather than fast: register
// double buffering of one chunk, no cp.async/TMA pipeline and no wgmma.  Each
// input pixel is read by up to 4 output pixels' taps and by every Co/BN column
// block, from L2.
//
// Layouts: x NHWC, y NHWC [N, oH, oW, Co] in x's dtype; w [9*C, Co] in x's
// dtype.  Requires C % 8 == 0, Co % 8 == 0 and 16-byte aligned pointers
// (checked by the wrapper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

struct Geom {
  int H, W, C, oH, oW, Co, M, K;  // M = N*oH*oW output pixels, K = 9*C
};

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
// keeps every 8-wide (and 4-wide) vector inside one tap.
__device__ __forceinline__ long long x_offset(const Pix& q, int k, const Geom& g) {
  if (!q.live || k >= g.K) return -1;
  const int tap = k / g.C, c = k - tap * g.C;
  const int iy = q.iy0 + tap / 3, ix = q.ix0 + tap % 3;
  if (iy < 0 || ix < 0 || iy >= g.H || ix >= g.W) return -1;
  return (long long)(q.base + (size_t)iy * g.W + ix) * g.C + c;
}

// ---- bf16: wmma on the tensor cores ----------------------------------------

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // GEMM depth per chunk
constexpr int THREADS = 256;  // 8 warps in 4 x 2, each a 32 x 32 piece
constexpr int A_LD = BK + 8;  // padded leading dims (multiples of 8 elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

constexpr int A_ELEMS = BM * A_LD;
constexpr int B_ELEMS = BK * B_LD;
constexpr int TILE_BYTES = 2 * (A_ELEMS + B_ELEMS) * 2;  // two A and two B buffers
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS)
conv_s2_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, Geom g) {
  // A [2][BM][A_LD] then B [2][BK][B_LD]; the epilogue's fp32 tile
  // [BM][C_LD] reuses the same bytes
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* const a_buf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const b_buf = a_buf + 2 * A_ELEMS;
  float* const c_buf = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A role: pixel rows ar and ar + 64, GEMM columns ac..ac+7 of the chunk
  const int ar = tid / 4, ac = (tid % 4) * 8;
  const Pix q0 = pixel(p0 + ar, g), q1 = pixel(p0 + ar + 64, g);
  // B role: chunk row br, output columns bc..bc+7
  const int br = tid / 8, bc = (tid % 8) * 8;
  const bool b_col = n0 + bc < g.Co;

  uint4 ra0, ra1, rb;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int k0) {
    const long long o0 = x_offset(q0, k0 + ac, g);
    const long long o1 = x_offset(q1, k0 + ac, g);
    ra0 = o0 < 0 ? zero : __ldg(reinterpret_cast<const uint4*>(x + o0));
    ra1 = o1 < 0 ? zero : __ldg(reinterpret_cast<const uint4*>(x + o1));
    const int kr = k0 + br;
    rb = (kr < g.K && b_col)
             ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)kr * g.Co + n0 + bc))
             : zero;
  };
  auto store = [&](int buf) {
    __nv_bfloat16* const As = a_buf + buf * A_ELEMS;
    *reinterpret_cast<uint4*>(As + ar * A_LD + ac) = ra0;
    *reinterpret_cast<uint4*>(As + (ar + 64) * A_LD + ac) = ra1;
    *reinterpret_cast<uint4*>(b_buf + buf * B_ELEMS + br * B_LD + bc) = rb;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = (g.K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load((kt + 1) * BK);  // next chunk's loads in flight
    const __nv_bfloat16* As = a_buf + cur * A_ELEMS;
    const __nv_bfloat16* Bs = b_buf + cur * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_buf + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  // 8 channels per thread per pass: one rounding to bf16, one 16-byte store
  for (int v = tid; v < BM * BN / 8; v += THREADS) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int p = p0 + r;
    if (p >= g.M || n0 + c >= g.Co) continue;
    uint4 packed;
    __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) pk[e] = __float2bfloat16(c_buf[r * C_LD + c + e]);
    *reinterpret_cast<uint4*>(y + (size_t)p * g.Co + n0 + c) = packed;
  }
}

// ---- fp32: FMA on the CUDA cores -------------------------------------------

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
    dim3 grid((g.M + BM - 1) / BM, (Co + BN - 1) / BN);
    conv_s2_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), g);
  }
  return static_cast<int>(cudaGetLastError());
}
