// DCNv2 backward for Hopper (sm_90a): the per-(pixel, tap) part (K3).
//
// Replaces ppyolo_tpu/ops/deform_conv_pallas.py::_dcn_bwd_pallas (kernel body
// _bwd_kernel).  The TPU kernel builds the one-hot selection matrix S once
// more and runs the col2im scatter as S^T @ d_sampled and the corner
// gradients as d_sampled @ x^T on the MXU, because the TPU has no fast
// scatter or gather.  Here both are what they are: gathers of four 16-byte
// corner rows and fp32 atomicAdd into a zeroed dx.  The two dense products
// around it stay outside, as in the JAX package (XLA einsums there, cuBLAS
// here): dm = g @ W^T before the kernel, dW = cols^T @ g after it.
//
// One warp owns one (output pixel, tap); each lane takes 8 channels per
// 256-channel step.  Per (pixel, tap) the warp recomputes the fp32 corner
// indices and weights exactly as K1 (dcn_fwd.cu) and _corner_tables do, then
//   sampled = sum_c w_c x[idx_c]               (fp32, from bf16 x)
//   dmod    = sum_C dm * sampled                (warp reduction)
//   dsamp   = dm * sigmoid(mask)                (fp32)
//   dx[idx_c] += w_c * dsamp                    (float4 atomicAdd, fp32)
//   dwgt_c  = sum_C dsamp * x[idx_c]            (warp reductions)
//   cols    = bf16(sampled * sigmoid(mask))     (the forward's columns, for dW)
// and lane 0 folds the vjp of _corner_tables into the epilogue: the offset
// gradient flows through the bilinear weights of the valid corners and
// through the clamp with jnp.clip's rule (half the gradient exactly at a
// bound, none outside), the mask gradient is dmod * m * (1 - m).  d_om is
// written once per element, so it needs no zeroing and no atomics.
//
// Bound on the H100: bytes.  At ppyolo_2x's stage-5 training shapes (batch 8,
// C = 512) a launch reads dm (26.6 MB) and x (11.8 MB at 38x38, 3.0 MB at
// 19x19) and writes cols (26.6 MB) and the fp32 dx (23.7 / 5.9 MB): ~30 us
// and ~19 us at 3.35 TB/s, against ~6 flops per byte.  This first version is
// simple rather than fast: x is re-read four times per tap from L2, and the
// dx scatter is 4 x C/4 vector atomics per (pixel, tap) into L2.
//
// Layouts: x NHWC bf16; om and d_om [N, oH, oW, 3*k2] in the layer's dtype
// T (bf16, or fp32 for an fp32 layer whose x the wrapper rounded to bf16);
// dm and cols [N*oH*oW, k2*C] bf16 (tap-major, then channel); dx NHWC fp32,
// zeroed by the wrapper.  Requires C % 8 == 0 and 16-byte aligned x, dm,
// cols and dx (checked by the wrapper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_CH = 8;                 // channels per lane per step
constexpr int STEP_CH = 32 * LANE_CH;      // channels per warp per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < LANE_CH; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// d clip(v, lo, hi) / dv as jnp.clip (maximum, then minimum) gives it
__device__ __forceinline__ float clip_grad(float v, float lo, float hi) {
  if (v > lo && v < hi) return 1.f;
  return (v == lo || v == hi) ? 0.5f : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_bwd_kernel(const __nv_bfloat16* __restrict__ x, const T* __restrict__ om,
               const __nv_bfloat16* __restrict__ dm, float* __restrict__ dx,
               T* __restrict__ d_om, __nv_bfloat16* __restrict__ cols,
               int N, int H, int W, int C, int oH, int oW, int kh, int kw,
               int stride, int pad) {
  const int lane = threadIdx.x % 32;
  const int k2 = kh * kw;
  const long long items = (long long)N * oH * oW * k2;
  const long long item = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= items) return;  // the whole warp leaves together
  const int tap = (int)(item % k2);
  const long long p = item / k2;  // n * oH * oW + oh * oW + ow
  const int n = (int)(p / (oH * oW));
  const int r = (int)(p % (oH * oW));
  const int oh = r / oW, ow = r % oW;
  const int om_c = 3 * k2;

  // corner table of (p, tap): _corner_tables line by line, in every lane
  const T* o = om + p * om_c;
  const float mod = 1.0f / (1.0f + expf(-to_f32(o[2 * k2 + tap])));
  const int ki = tap / kw, kj = tap % kw;
  const float ry = (float)(oh * stride - pad + ki) + to_f32(o[2 * tap]);
  const float rx = (float)(ow * stride - pad + kj) + to_f32(o[2 * tap + 1]);
  const float lo = -(float)pad, hy = (float)(H - 1 + pad), hx = (float)(W - 1 + pad);
  const float py = fminf(fmaxf(ry, lo), hy);
  const float px = fminf(fmaxf(rx, lo), hx);
  const float y0 = floorf(py), x0 = floorf(px);
  const float ly = py - y0, lx = px - x0;
  const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                       ly * (1.f - lx), ly * lx};
  int idx[4];
  float wgt[4];
  bool valid[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float yc = y0 + (float)(c / 2), xc = x0 + (float)(c % 2);
    valid[c] = yc >= 0.f && yc <= (float)(H - 1) && xc >= 0.f && xc <= (float)(W - 1);
    const int yi = (int)fminf(fmaxf(yc, 0.f), (float)(H - 1));
    const int xi = (int)fminf(fmaxf(xc, 0.f), (float)(W - 1));
    idx[c] = yi * W + xi;
    wgt[c] = valid[c] ? cw[c] : 0.f;
  }

  const __nv_bfloat16* xn = x + (size_t)n * H * W * C;
  float* dxn = dx + (size_t)n * H * W * C;
  const size_t row = ((size_t)p * k2 + tap) * C;  // dm / cols offset
  float dmod = 0.f, dwgt[4] = {0.f, 0.f, 0.f, 0.f};

  for (int c0 = lane * LANE_CH; c0 < C; c0 += STEP_CH) {
    float g[LANE_CH], xv[4][LANE_CH], s[LANE_CH], ds[LANE_CH];
    unpack8(*reinterpret_cast<const uint4*>(dm + row + c0), g);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      unpack8(__ldg(reinterpret_cast<const uint4*>(xn + (size_t)idx[c] * C + c0)), xv[c]);
#pragma unroll
    for (int j = 0; j < LANE_CH; ++j) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) v += wgt[c] * xv[c][j];
      s[j] = v;
      dmod += g[j] * v;
      ds[j] = g[j] * mod;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < LANE_CH; ++j) acc += ds[j] * xv[c][j];
      dwgt[c] += acc;
    }
    uint4 packed;
    __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int j = 0; j < LANE_CH; ++j) pk[j] = __float2bfloat16(s[j] * mod);
    *reinterpret_cast<uint4*>(cols + row + c0) = packed;
    // col2im: the scatter of w_c * dsamp into the corners that exist
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!valid[c]) continue;
      const float w = wgt[c];
      float4* dst = reinterpret_cast<float4*>(dxn + (size_t)idx[c] * C + c0);
      atomicAdd(dst, make_float4(w * ds[0], w * ds[1], w * ds[2], w * ds[3]));
      atomicAdd(dst + 1, make_float4(w * ds[4], w * ds[5], w * ds[6], w * ds[7]));
    }
  }

  dmod = warp_sum(dmod);
#pragma unroll
  for (int c = 0; c < 4; ++c) dwgt[c] = warp_sum(dwgt[c]);
  if (lane == 0) {
    // vjp of wgt_c = cw_c(ly, lx) * valid_c, ly = clip(ry) - floor(.), ...
    float d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = valid[c] ? dwgt[c] : 0.f;
    const float dly = -(1.f - lx) * d[0] - lx * d[1] + (1.f - lx) * d[2] + lx * d[3];
    const float dlx = -(1.f - ly) * d[0] + (1.f - ly) * d[1] - ly * d[2] + ly * d[3];
    T* q = d_om + p * om_c;
    store_out(q + 2 * tap, dly * clip_grad(ry, lo, hy));
    store_out(q + 2 * tap + 1, dlx * clip_grad(rx, lo, hx));
    store_out(q + 2 * k2 + tap, dmod * mod * (1.f - mod));
  }
}

template <typename T>
void launch(const void* x, const void* om, const void* dm, void* dx, void* d_om,
            void* cols, int N, int H, int W, int C, int oH, int oW, int kh, int kw,
            int stride, int pad, cudaStream_t stream) {
  const long long items = (long long)N * oH * oW * kh * kw;
  const unsigned blocks = (unsigned)((items + WARPS - 1) / WARPS);
  dcn_bwd_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const T*>(om),
      static_cast<const __nv_bfloat16*>(dm), static_cast<float*>(dx),
      static_cast<T*>(d_om), static_cast<__nv_bfloat16*>(cols),
      N, H, W, C, oH, oW, kh, kw, stride, pad);
}

}  // namespace

// om and d_om are fp32 when is_f32, else bf16; x, dm and cols are bf16, dx fp32.
extern "C" int dcn_bwd_launch(const void* x, const void* om, const void* dm, void* dx,
                              void* d_om, void* cols, int is_f32, int N, int H, int W,
                              int C, int oH, int oW, int kh, int kw, int stride, int pad,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    launch<float>(x, om, dm, dx, d_om, cols, N, H, W, C, oH, oW, kh, kw, stride, pad, s);
  else
    launch<__nv_bfloat16>(x, om, dm, dx, d_om, cols, N, H, W, C, oH, oW, kh, kw, stride,
                          pad, s);
  return static_cast<int>(cudaGetLastError());
}
