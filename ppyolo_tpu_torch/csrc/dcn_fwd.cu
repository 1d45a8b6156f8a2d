// DCNv2 forward for Hopper (sm_90a), bf16 tensor cores with fp32 accumulation.
//
// Replaces ppyolo_tpu/ops/deform_conv_pallas.py::deform_conv2d_pallas (kernel
// body _kernel).  The TPU kernel builds a one-hot selection matrix S and runs
// the bilinear gather as S @ x on the MXU, because gathers are slow on the
// TPU.  Here the gather is a plain load: each block owns BM output pixels x
// BN output channels and loops over the k2 taps and over C in BK-channel
// chunks.  Per (pixel, tap) it computes the four corner indices and weights in
// fp32 (the clamping of ppyolo_tpu/ops/deform_conv_pallas.py::_corner_tables),
// interpolates 8 channels per thread from four 16-byte loads, multiplies by
// sigmoid(mask), rounds to bf16 into a shared-memory A tile, and multiplies
// it with the matching rows of the packed weight [k2*C, outC] on the tensor
// cores (wmma 16x16x16).  The [N, P, k2, C] columns never reach device memory.
//
// Bound on the H100: at ppyolo_2x's stage-5 shapes (batch 8, C = outC = 512,
// 19x19 outputs) a launch is 13.6 GFLOP against ~11-20 MB of traffic, so the
// tensor-core rate bounds it (~14 us at 989 TFLOP/s).  This first version
// is simple rather than fast: no cp.async/TMA pipeline and no wgmma, one
// __syncthreads-separated load/compute stage per chunk.  The gather reads x
// four times per tap from L2 (x is 1.5-5.9 MB, L2-resident).
//
// Layouts: x NHWC bf16; om [N, oH, oW, 3*k2] (channels 0..2k2 are (y, x)
// offsets per tap, 2k2..3k2 mask logits) and y NHWC, both in the layer's
// dtype T (bf16, or fp32 for an fp32 layer whose x the wrapper rounded to
// bf16); w [k2*C, outC] bf16 (tap-major, then input channel); bias fp32
// [outC] or null.  Requires C % 32 == 0 and outC % 64 == 0 (checked by the
// wrapper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per chunk
constexpr int THREADS = 256;  // 8 warps, each a 16 x 32 piece of the tile
constexpr int A_LD = BK + 8;  // padded leading dims (multiples of 8 elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const __nv_bfloat16* __restrict__ x, const T* __restrict__ om,
               const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
               T* __restrict__ y, int N, int H, int W, int C, int oH, int oW,
               int outC, int kh, int kw, int stride, int pad) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ int s_idx[BM][4];
  __shared__ float s_wgt[BM][4];
  __shared__ float s_mod[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int P = N * oH * oW;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k2 = kh * kw;
  const int om_c = 3 * k2;

  // A-tile role: pixel row ar, channels ac..ac+7 of the chunk
  const int ar = tid / 4, ac = (tid % 4) * 8;
  // B-tile role: chunk row br, output columns bc..bc+7
  const int br = tid / 8, bc = (tid % 8) * 8;
  const int ap = p0 + ar;
  const bool a_live = ap < P;
  const __nv_bfloat16* xn = x + (size_t)(a_live ? ap / (oH * oW) : 0) * H * W * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int tap = 0; tap < k2; ++tap) {
    if (tid < BM) {
      // corner table of (pixel p0 + tid, tap): _corner_tables line by line
      int idx[4] = {0, 0, 0, 0};
      float wgt[4] = {0.f, 0.f, 0.f, 0.f};
      float mod = 0.f;
      const int p = p0 + tid;
      if (p < P) {
        const int r = p % (oH * oW);
        const int oh = r / oW, ow = r % oW;
        const T* o = om + (size_t)p * om_c;
        const float off_y = to_f32(o[2 * tap]);
        const float off_x = to_f32(o[2 * tap + 1]);
        mod = 1.0f / (1.0f + expf(-to_f32(o[2 * k2 + tap])));
        const int ki = tap / kw, kj = tap % kw;
        float py = (float)(oh * stride - pad + ki) + off_y;
        float px = (float)(ow * stride - pad + kj) + off_x;
        py = fminf(fmaxf(py, -(float)pad), (float)(H - 1 + pad));
        px = fminf(fmaxf(px, -(float)pad), (float)(W - 1 + pad));
        const float y0 = floorf(py), x0 = floorf(px);
        const float ly = py - y0, lx = px - x0;
        const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                             ly * (1.f - lx), ly * lx};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float yc = y0 + (float)(c / 2), xc = x0 + (float)(c % 2);
          const bool valid = yc >= 0.f && yc <= (float)(H - 1) &&
                             xc >= 0.f && xc <= (float)(W - 1);
          const int yi = (int)fminf(fmaxf(yc, 0.f), (float)(H - 1));
          const int xi = (int)fminf(fmaxf(xc, 0.f), (float)(W - 1));
          idx[c] = yi * W + xi;
          wgt[c] = valid ? cw[c] : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_idx[tid][c] = idx[c];
        s_wgt[tid][c] = wgt[c];
      }
      s_mod[tid] = mod;
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += BK) {
      // A: bilinear sample of 8 channels, modulated, rounded to bf16
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (a_live) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wc = s_wgt[ar][c];
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              xn + (size_t)s_idx[ar][c] * C + c0 + ac));
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += wc * __bfloat162float(e[j]);
        }
        const float m = s_mod[ar];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= m;
      }
      uint4 packed;
      __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) pk[j] = __float2bfloat16(v[j]);
      *reinterpret_cast<uint4*>(&As[ar * A_LD + ac]) = packed;

      // B: rows tap*C + c0 .. +BK of the packed weight
      const size_t krow = (size_t)tap * C + c0 + br;
      *reinterpret_cast<uint4*>(&Bs[br * B_LD + bc]) =
          __ldg(reinterpret_cast<const uint4*>(w + krow * outC + n0 + bc));
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wm * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + (wm * 16) * C_LD + wn * 32 + j * 16, acc[j],
                            C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int p = p0 + r;
    if (p >= P) continue;
    float val = Cs[r * C_LD + c];
    if (bias != nullptr) val += bias[n0 + c];
    store_out(y + (size_t)p * outC + n0 + c, val);
  }
}

template <typename T>
void launch(const void* x, const void* om, const void* w, const void* bias, void* y,
            int N, int H, int W, int C, int oH, int oW, int outC, int kh, int kw,
            int stride, int pad, cudaStream_t stream) {
  const int P = N * oH * oW;
  dim3 grid((P + BM - 1) / BM, outC / BN);
  dcn_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const T*>(om),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), N, H, W, C, oH, oW, outC, kh, kw, stride, pad);
}

}  // namespace

// om and y are fp32 when is_f32, else bf16; x and w are always bf16.
extern "C" int dcn_fwd_launch(const void* x, const void* om, const void* w,
                              const void* bias, void* y, int is_f32,
                              int N, int H, int W, int C, int oH, int oW, int outC,
                              int kh, int kw, int stride, int pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    launch<float>(x, om, w, bias, y, N, H, W, C, oH, oW, outC, kh, kw, stride, pad, s);
  else
    launch<__nv_bfloat16>(x, om, w, bias, y, N, H, W, C, oH, oW, outC, kh, kw, stride, pad, s);
  return static_cast<int>(cudaGetLastError());
}
