// K5: int8 conv of the int8 serving mode (k in {1, 3}, stride in {1, 2}, pad
// (k-1)/2) as an implicit GEMM for Hopper (sm_90a).
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
// * The A tile is quantized as it is loaded: each thread reads 8 bf16
//   channels of a pixel (one 16-byte load when C % 8 == 0, else 4- or 2-byte
//   loads), computes clip(rint(f32(x) / s_x), -127, 127) with a true division
//   (__fdiv_rn) and round half to even (__float2int_rn), and stores 8 int8
//   bytes in shared memory.  Padding and channels past C load as 0 and stay 0.
//   So no int8 activation tensor is ever written to device memory.
// * B is the packed weight, K-major [Co, k*k*Cp] int8 (pack_int8_weight: each
//   tap's C channels zero-padded to Cp, a multiple of 16, so every 16-byte
//   load is aligned and the K tail reads zeros).
// * The product is mma.sync m16n8k32 s8 x s8 -> s32, A and B fragments read
//   from shared memory by 32-bit loads (rows 80 bytes apart: conflict-free).
//   Block tile 128 pixels x 128 channels x 64 bytes of K, 8 warps of 32 x 64.
//   Two shared-memory stages: the next chunk's global loads are issued before
//   the current chunk's products and quantized into the other stage after.
// * Epilogue: y = bf16_rn(f32_rn(acc) * (s_x * w_scale[o])) (+ bias, added in
//   fp32 and rounded to bf16 once more), the JAX order, every step correctly
//   rounded (no FMA contraction), so the result is bit-equal to the plain
//   version (ops/conv_int8.py::quantized_conv2d_plain).
//
// Bound on the H100 (ppyolo_2x@608 b8): the 65 convs are 1,979 TOP/s int8
// tensor-core work against bf16 activations read once and written once at
// 3.35 TB/s; most are bound by bytes (chip_smoke prints each shape's bound).
// This first form is simple and right; wgmma s8, TMA and a fused amax for the
// dynamic scale are later work.
//
// Layouts: x NHWC bf16, y NHWC [N, oH, oW, Co] bf16, w_scale [Co] fp32, s_x one
// fp32 on the device, bias [Co] bf16 or null.  Requires Co even and x and the
// packed weight 16-byte aligned (checked by the wrapper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // output pixels per block
constexpr int BN = 128;            // output channels per block
constexpr int BK = 64;             // K bytes (input channels of one tap) per chunk
constexpr int THREADS = 256;       // 8 warps: 4 along M x 2 along N, 32 x 64 each
constexpr int LDS = BK + 16;       // shared row stride in bytes
constexpr int A_TILE = BM * LDS;
constexpr int B_TILE = BN * LDS;
constexpr int STAGE = A_TILE + B_TILE;

struct Geom {
  int H, W, C, Cp, Co, k, stride, pad, oH, oW, M, Kp, cchunks, KT;
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One int8 of bf16 bits `h` (the low 16 bits) at scale s.
__device__ __forceinline__ uint32_t quant1(uint32_t h, float s) {
  const float v = __uint_as_float((h & 0xffffu) << 16);
  int q = __float2int_rn(__fdiv_rn(v, s));
  q = min(max(q, -127), 127);
  return static_cast<uint32_t>(q) & 0xffu;
}

// 8 bf16 (a uint4) -> 8 int8 (a uint2), channel order kept.
__device__ __forceinline__ uint2 quant8(uint4 r, float s) {
  uint2 o;
  o.x = quant1(r.x, s) | (quant1(r.x >> 16, s) << 8) | (quant1(r.y, s) << 16) |
        (quant1(r.y >> 16, s) << 24);
  o.y = quant1(r.z, s) | (quant1(r.z >> 16, s) << 8) | (quant1(r.w, s) << 16) |
        (quant1(r.w >> 16, s) << 24);
  return o;
}

// Channels c .. c+7 of the pixel whose channel 0 is at element `off` of x,
// as 8 bf16 in a uint4; 0 where the pixel is outside the image or c+j >= C.
// VEC is the channels one load reads: 8 (C % 8 == 0), 2 (C even) or 1.
template <int VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ x, long long off,
                                       int c, int C, bool ok) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return r;
  if (VEC == 8) {
    if (c < C) r = __ldg(reinterpret_cast<const uint4*>(x + off + c));
    return r;
  }
  const unsigned short* p = reinterpret_cast<const unsigned short*>(x + off);
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; j += VEC) {
    if (VEC == 2) {
      const uint32_t v = c + j < C ? __ldg(reinterpret_cast<const unsigned int*>(p + c + j)) : 0u;
      h[j] = v & 0xffffu;
      h[j + 1] = v >> 16;
    } else {
      h[j] = c + j < C ? static_cast<uint32_t>(__ldg(p + c + j)) : 0u;
    }
  }
  r.x = h[0] | (h[1] << 16);
  r.y = h[2] | (h[3] << 16);
  r.z = h[4] | (h[5] << 16);
  r.w = h[6] | (h[7] << 16);
  return r;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
conv_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ s_x_ptr,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                 Geom g) {
  __shared__ __align__(16) uint8_t smem[2 * STAGE];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float sx = *s_x_ptr;

  // A role: rows a_row + 32 i (i < 4), channels 8 * a_ch .. +7 of the chunk
  const int a_row = tid / 8, a_ch = tid % 8;
  long long a_off[4];  // element offset of the row's input pixel at tap (0, 0)
  int a_iy[4], a_ix[4];
  const int hw = g.oH * g.oW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + a_row + 32 * i;
    const bool live = p < g.M;
    const int pp = live ? p : 0;
    const int n = pp / hw, r = pp - n * hw;
    const int oy = r / g.oW, ox = r - oy * g.oW;
    a_iy[i] = live ? oy * g.stride - g.pad : -(1 << 28);  // a dead row fails every bound
    a_ix[i] = ox * g.stride - g.pad;
    a_off[i] = ((long long)(n * g.H + a_iy[i]) * g.W + a_ix[i]) * g.C;
  }
  // B role: output channels b_row + 64 i (i < 2), 16 bytes at 16 * b_ch of the chunk
  const int b_row = tid / 4, b_ch = tid % 4;
  const int8_t* b_ptr[2];
  bool b_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int co = n0 + b_row + 64 * i;
    b_live[i] = co < g.Co;
    b_ptr[i] = w + (size_t)(b_live[i] ? co : 0) * g.Kp;
  }

  uint4 ra[4], rb[2];
  auto load = [&](int kt) {
    const int tap = kt / g.cchunks;
    const int c0 = (kt - tap * g.cchunks) * BK;
    const int dy = tap / g.k, dx = tap - dy * g.k;
    const int c = c0 + 8 * a_ch;
    const long long tap_off = (long long)(dy * g.W + dx) * g.C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
      const bool ok = (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
      ra[i] = load8<VEC>(x, a_off[i] + tap_off, c, g.C, ok);
    }
    const int cb = c0 + 16 * b_ch;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (b_live[i] && cb < g.Cp)
        rb[i] = __ldg(reinterpret_cast<const uint4*>(b_ptr[i] + tap * g.Cp + cb));
    }
  };
  auto store = [&](int stage) {
    uint8_t* as = smem + stage * STAGE;
    uint8_t* bs = as + A_TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint2*>(as + (a_row + 32 * i) * LDS + 8 * a_ch) = quant8(ra[i], sx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(bs + (b_row + 64 * i) * LDS + 16 * b_ch) = rb[i];
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int wm = warp % 4, wn = warp / 4;
  const int gq = lane / 4, tq = lane % 4;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < g.KT; ++kt) {
    const bool more = kt + 1 < g.KT;
    if (more) load(kt + 1);  // in flight while the tensor cores work on chunk kt
    const uint8_t* as = smem + (kt & 1) * STAGE;
    const uint8_t* bs = as + A_TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kb = ks * 32 + 4 * tq;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* r = as + (wm * 32 + mi * 16 + gq) * LDS + kb;
        a[mi][0] = lds32(r);
        a[mi][1] = lds32(r + 8 * LDS);
        a[mi][2] = lds32(r + 16);
        a[mi][3] = lds32(r + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint8_t* r = bs + (wn * 64 + ni * 8 + gq) * LDS + kb;
        const uint32_t b0 = lds32(r), b1 = lds32(r + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    if (more) store((kt + 1) & 1);  // the stage chunk kt-1 read, free since the last barrier
    __syncthreads();
  }

  // epilogue: c0, c1 at (row gq, columns 2 tq, 2 tq + 1), c2, c3 eight rows below
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int co = n0 + wn * 64 + ni * 8 + 2 * tq;
    if (co >= g.Co) continue;
    const float sc0 = __fmul_rn(sx, w_scale[co]), sc1 = __fmul_rn(sx, w_scale[co + 1]);
    float bias0 = 0.f, bias1 = 0.f;
    if (bias != nullptr) {
      bias0 = __bfloat162float(bias[co]);
      bias1 = __bfloat162float(bias[co + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm * 32 + mi * 16 + gq + 8 * h;
        if (p >= g.M) continue;
        __nv_bfloat16 v0 = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), sc0));
        __nv_bfloat16 v1 =
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), sc1));
        if (bias != nullptr) {
          v0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v0), bias0));
          v1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v1), bias1));
        }
        __nv_bfloat162 pair;
        pair.x = v0;
        pair.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)p * g.Co + co) = pair;
      }
    }
  }
}

}  // namespace

// Blocks of the kernel that fit one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the CUDA error.
extern "C" int conv_int8_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conv_int8_kernel<8>, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// bias may be null.  Returns the launch's CUDA error (0 on success).
extern "C" int conv_int8_launch(const void* x, const void* w, const void* w_scale,
                                const void* s_x, const void* bias, void* y, int N, int H, int W,
                                int C, int Co, int k, int stride, int oH, int oW, void* stream) {
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Cp = (C + 15) / 16 * 16;
  g.Co = Co;
  g.k = k;
  g.stride = stride;
  g.pad = (k - 1) / 2;
  g.oH = oH;
  g.oW = oW;
  g.M = N * oH * oW;
  g.Kp = k * k * g.Cp;
  g.cchunks = (C + BK - 1) / BK;
  g.KT = k * k * g.cchunks;
  const dim3 grid((g.M + BM - 1) / BM, (Co + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const int8_t*>(w);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* sx = static_cast<const float*>(s_x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (C % 8 == 0)
    conv_int8_kernel<8><<<grid, THREADS, 0, s>>>(xb, wb, ws, sx, bb, yb, g);
  else if (C % 2 == 0)
    conv_int8_kernel<2><<<grid, THREADS, 0, s>>>(xb, wb, ws, sx, bb, yb, g);
  else
    conv_int8_kernel<1><<<grid, THREADS, 0, s>>>(xb, wb, ws, sx, bb, yb, g);
  return static_cast<int>(cudaGetLastError());
}
