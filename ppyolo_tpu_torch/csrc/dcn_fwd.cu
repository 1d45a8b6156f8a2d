// K1: DCNv2 forward for Hopper (sm_90a), bf16 wgmma with fp32 accumulation.
//
// Replaces ppyolo_tpu/ops/deform_conv_pallas.py::deform_conv2d_pallas (kernel
// body _kernel).  The TPU kernel builds a one-hot selection matrix S and runs
// the bilinear gather as S @ x on the MXU, because gathers are slow on the
// TPU.  Here the gather is a plain load, and the product one implicit GEMM
// with M = N*oH*oW output pixels, N = outC and K = k2 taps x C channels whose
// A tile (the interpolated, modulated columns) never reaches device memory.
//
// Bound on the H100 at ppyolo_2x's stage-5 serving shapes (batch 8, C = outC
// = 512, 19x19 outputs, 2888 pixels): 13.6 GFLOP a launch against 11-20 MB
// of traffic, so the tensor-core rate bounds it (13.8 us at 989 TFLOP/s).
// What the design has to keep small is L2 traffic: every output-column block
// re-reads the gathered corners (4 x 16 bytes per 8 channels per tap, ~106 MB
// a launch if no corner were reused) and every pixel block the whole weight
// (4.7 MB).
//
// Design (what it does about that):
// * A block owns 64 output pixels x 128 * NW output channels: NW = 2 at
//   outC > 128, so stage 5 is 46 x 2 = 92 blocks (one per SM, under one wave
//   of 132) and each pixel is gathered twice a launch instead of 8 times.
// * Warp-specialised.  At the start every thread fills a shared-memory
//   corner table of (tap, pixel): four corner indices, four bilinear weights
//   (zero for a corner outside the image) and sigmoid(mask), the clamping of
//   ppyolo_tpu/ops/deform_conv_pallas.py::_corner_tables in fp32 -- once per
//   block, not once per column block and chunk.  Then two producer
//   warpgroups take the k-steps in turn: each interpolates 64 channels of
//   the 64 pixels for one tap from four 16-byte corner loads per 8 channels
//   (fp32 sum, times sigmoid(mask), one bf16 rounding: the arithmetic of the
//   first version) straight into a 128-byte-swizzled A stage, and copies the
//   matching B tile of the K-major weight [outC, k2*C] with cp.async.  NW
//   consumer warpgroups run wgmma m64n128k16 on each stage (A and B from
//   shared memory) into 64 fp32 accumulators a thread.
// * A 4-stage ring; stage s belongs to producer warpgroup s % 2.  The
//   hand-off is two named barriers per stage (full: producer arrives,
//   consumers wait; empty: consumers arrive once their wgmma of the stage
//   has retired, the producer waits), so producers run up to four k-steps
//   ahead of the products.
// * K runs chunk-major, tap-minor: the nine taps of one 64-channel chunk
//   touch one small window of x, which stays in L1 (the corner loads go
//   through the non-coherent L1 path; the weight's cp.async.cg bypasses L1).
// * Epilogue straight from the accumulators: optional fp32 bias, one
//   rounding to T, pairs of columns per store, predicated on the pixel tail
//   and on outC (a warpgroup whose 128 columns lie past outC skips its
//   products).
// What the card shows (chip_smoke, H100 80GB HBM3 at 700 W): 178 TFLOP/s,
// 5.6x the bound, alike at both stage-5 shapes and on L2-cold inputs.  In a
// scratch A/B a 64 x 128 tile (184 blocks), a 2-stage ring, one or three
// producer warpgroups, and weight copies issued by the consumers were no
// faster; without the gather's loads, or without the products, it ran only
// a little faster, so neither L2 nor the tensor cores alone set its time.
// Left for a later PR: the operands' shared-memory traffic (A read by both
// consumer warpgroups, 32 KB of B a k-step) beside the producers' stores,
// which 128-pixel tiles with m64n256 products would cut; the weight re-read
// by each of the 46 pixel blocks (a TMA multicast across a cluster); and the
// 40 SMs that 92 blocks leave idle.
//
// Layouts: x NHWC bf16; om [N, oH, oW, 3*k2] (channels 0..2k2 are (y, x)
// offsets per tap, 2k2..3k2 mask logits) and y NHWC, both in the layer's
// dtype T (bf16, or fp32 for an fp32 layer whose x the wrapper rounded to
// bf16); w K-major [outC, k2*C] bf16 (column tap*C + c); bias fp32 [outC] or
// null.  Requires C % 8 == 0, outC % 8 == 0 and 16-byte aligned x and w (the
// wrapper checks C % 32 and outC % 64).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;           // output pixels per block (one wgmma M)
constexpr int BK = 64;           // channels per k-step: one 128-byte swizzle row
constexpr int STAGES = 4;        // ring depth
constexpr int PRODUCERS = 2;     // producer warpgroups, k-step ks on ks % 2
constexpr int A_BYTES = BM * BK * 2;
constexpr int TABLE_ENTRY = 16 + 16 + 4;  // int4 indices, float4 weights, modulation
constexpr int FULL_BAR = 1;               // named barriers FULL_BAR + s, EMPTY_BAR + s
constexpr int EMPTY_BAR = FULL_BAR + STAGES;
static_assert(STAGES % PRODUCERS == 0, "each stage belongs to one producer warpgroup");
static_assert(EMPTY_BAR + STAGES <= 16, "16 hardware barriers");

struct Geom {
  int N, H, W, C, oH, oW, outC, kh, kw, stride, pad, P, K, k2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int NW>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + 128 * NW * BK * 2; }

template <int NW>
int smem_bytes(int k2) { return 1024 + STAGES * stage_bytes<NW>() + k2 * BM * TABLE_ENTRY; }

template <int NW, typename T>
__global__ void __launch_bounds__(128 * (PRODUCERS + NW), 1)
dcn_fwd_kernel(const __nv_bfloat16* __restrict__ x, const T* __restrict__ om,
               const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
               T* __restrict__ y, Geom g) {
  constexpr int STAGE_BYTES = stage_bytes<NW>();
  constexpr int BAR_THREADS = 128 * (1 + NW);  // one producer + the consumers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms on 1024-byte boundaries
  unsigned char* const ring = smem_raw + (base - raw);
  int4* const t_idx = reinterpret_cast<int4*>(ring + STAGES * STAGE_BYTES);  // [k2][BM]
  float4* const t_wgt = reinterpret_cast<float4*>(t_idx + g.k2 * BM);
  float* const t_mod = reinterpret_cast<float*>(t_wgt + g.k2 * BM);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * 128 * NW;

  // corner table of every (tap, pixel): _corner_tables line by line.  An
  // index is a pixel of the whole NHWC tensor; -1 marks a pixel past P.
  for (int e = tid; e < g.k2 * BM; e += blockDim.x) {
    const int tap = e / BM, r = e - tap * BM;
    const int p = p0 + r;
    int4 idx = make_int4(-1, 0, 0, 0);
    float4 wgt = make_float4(0.f, 0.f, 0.f, 0.f);
    float mod = 0.f;
    if (p < g.P) {
      const int n = p / (g.oH * g.oW), rr = p - n * (g.oH * g.oW);
      const int oh = rr / g.oW, ow = rr - oh * g.oW;
      const T* o = om + (size_t)p * 3 * g.k2;
      const float off_y = to_f32(o[2 * tap]);
      const float off_x = to_f32(o[2 * tap + 1]);
      mod = 1.0f / (1.0f + expf(-to_f32(o[2 * g.k2 + tap])));
      const int ki = tap / g.kw, kj = tap % g.kw;
      float py = (float)(oh * g.stride - g.pad + ki) + off_y;
      float px = (float)(ow * g.stride - g.pad + kj) + off_x;
      py = fminf(fmaxf(py, -(float)g.pad), (float)(g.H - 1 + g.pad));
      px = fminf(fmaxf(px, -(float)g.pad), (float)(g.W - 1 + g.pad));
      const float y0 = floorf(py), x0 = floorf(px);
      const float ly = py - y0, lx = px - x0;
      const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                           ly * (1.f - lx), ly * lx};
      int ci[4];
      float cwv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float yc = y0 + (float)(c / 2), xc = x0 + (float)(c % 2);
        const bool valid = yc >= 0.f && yc <= (float)(g.H - 1) &&
                           xc >= 0.f && xc <= (float)(g.W - 1);
        const int yi = (int)fminf(fmaxf(yc, 0.f), (float)(g.H - 1));
        const int xi = (int)fminf(fmaxf(xc, 0.f), (float)(g.W - 1));
        ci[c] = (n * g.H + yi) * g.W + xi;
        cwv[c] = valid ? cw[c] : 0.f;
      }
      idx = make_int4(ci[0], ci[1], ci[2], ci[3]);
      wgt = make_float4(cwv[0], cwv[1], cwv[2], cwv[3]);
    }
    t_idx[e] = idx;
    t_wgt[e] = wgt;
    t_mod[e] = mod;
  }
  __syncthreads();

  const int KT = ((g.C + BK - 1) / BK) * g.k2;  // k-step ks: chunk ks / k2, tap ks % k2

  if (wg < PRODUCERS) {
    // ---- producer: the gather into A, cp.async of B ----------------------
    const int t = tid % 128;
    const int j = t % 8;   // 16-byte piece: channels 8j..8j+7 of the chunk
    const int r0 = t / 8;  // A rows r0 + 16 i (i < 4), B rows r0 + 16 i (i < 8 NW)
    for (int ks = wg; ks < KT; ks += PRODUCERS) {
      const int s = ks % STAGES;
      if (ks >= STAGES) sm90::named_barrier(EMPTY_BAR + s, BAR_THREADS);
      const int tap = ks % g.k2;
      const int c = (ks / g.k2) * BK + 8 * j;
      const bool c_ok = c < g.C;
      const uint32_t sa = base + s * STAGE_BYTES, sb = sa + A_BYTES;
#pragma unroll
      for (int i = 0; i < 8 * NW; ++i) {
        const int row = r0 + 16 * i;
        const bool ok = c_ok && n0 + row < g.outC;
        sm90::cp_async_16(sb + sm90::swz128(row, j),
                          ok ? w + (size_t)(n0 + row) * g.K + tap * g.C + c : w, ok ? 16 : 0);
      }
      sm90::cp_async_commit();

      uint4 cr[4][4];  // the four rows' four corners, all loads in flight at once
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 id = t_idx[tap * BM + r0 + 16 * i];
        const bool live = c_ok && id.x >= 0;
        const int ids[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cr[i][q] = live ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)ids[q] * g.C + c))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 16 * i;
        const float4 wv = t_wgt[tap * BM + row];
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
        const float m = t_mod[tap * BM + row];
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&cr[i][q]);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += wq[q] * __bfloat162float(h[e]);
        }
        uint4 packed;
        __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[e] = __floats2bfloat162_rn(v[2 * e] * m, v[2 * e + 1] * m);
        *reinterpret_cast<uint4*>(ring + s * STAGE_BYTES + sm90::swz128(row, j)) = packed;
      }
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();  // st.shared and cp.async writes -> wgmma's async proxy
      sm90::named_barrier_arrive(FULL_BAR + s, BAR_THREADS);
    }
    return;
  }

  // ---- consumers: wgmma over the ring, then the epilogue -----------------
  const int cw = wg - PRODUCERS;               // output columns n0 + 128 cw ..
  const bool live = n0 + 128 * cw < g.outC;    // warpgroup-uniform
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < KT; ++ks) {
    const int s = ks % STAGES;
    sm90::named_barrier(FULL_BAR + s, BAR_THREADS);
    if (live) {
      const uint32_t sa = base + s * STAGE_BYTES;
      const uint64_t da = sm90::desc_sw128(sa);
      const uint64_t db = sm90::desc_sw128(sa + A_BYTES + cw * 128 * BK * 2);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // k16 step: 32 bytes further in the atom
        sm90::wgmma_m64n128k16_ss(acc, da + 2 * kk, db + 2 * kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // k-step ks may run on; ks - 1 has retired
    }
    // free the stage of k-step ks - 1 for k-step ks - 1 + STAGES, if there is one
    if (ks >= 1 && ks - 1 + STAGES < KT)
      sm90::named_barrier_arrive(EMPTY_BAR + (ks - 1) % STAGES, BAR_THREADS);
  }
  if (!live) return;
  sm90::wgmma_wait<0>();

  const int lane = tid % 32;
  const int r = 16 * ((tid % 128) / 32) + lane / 4;
  const int cb = n0 + 128 * cw + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = cb + 8 * i;
    if (col >= g.outC) continue;
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + r + 8 * h;
      if (p < g.P)
        store2(y + (size_t)p * g.outC + col, acc[4 * i + 2 * h] + b0, acc[4 * i + 2 * h + 1] + b1);
    }
  }
}

template <int NW, typename T>
int launch(const void* x, const void* om, const void* w, const void* bias, void* y,
           const Geom& g, cudaStream_t stream) {
  const int smem = smem_bytes<NW>(g.k2);
  static int attr_bytes = 0;  // the dynamic shared memory granted so far
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_fwd_kernel<NW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = smem;
  }
  dim3 grid((g.P + BM - 1) / BM, (g.outC + 128 * NW - 1) / (128 * NW));
  dcn_fwd_kernel<NW, T><<<grid, 128 * (PRODUCERS + NW), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const T*>(om),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* x, const void* om, const void* w, const void* bias, void* y,
             const Geom& g, cudaStream_t stream) {
  // two consumer warpgroups (256 columns) unless outC fits one
  return g.outC > 128 ? launch<2, T>(x, om, w, bias, y, g, stream)
                      : launch<1, T>(x, om, w, bias, y, g, stream);
}

}  // namespace

// Blocks of the stage-5 instantiation (bf16, 256 columns, 3x3 taps) that fit
// one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA
// error.
extern "C" int dcn_fwd_blocks_per_sm() {
  const int smem = smem_bytes<2>(9);
  cudaError_t err = cudaFuncSetAttribute(dcn_fwd_kernel<2, __nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, dcn_fwd_kernel<2, __nv_bfloat16>, 128 * (PRODUCERS + 2), smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// om and y are fp32 when is_f32, else bf16; x and w are always bf16.
extern "C" int dcn_fwd_launch(const void* x, const void* om, const void* w,
                              const void* bias, void* y, int is_f32,
                              int N, int H, int W, int C, int oH, int oW, int outC,
                              int kh, int kw, int stride, int pad, void* stream) {
  Geom g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.C = C;
  g.oH = oH;
  g.oW = oW;
  g.outC = outC;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.pad = pad;
  g.P = N * oH * oW;
  g.k2 = kh * kw;
  g.K = g.k2 * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_t<float>(x, om, w, bias, y, g, s)
                : launch_t<__nv_bfloat16>(x, om, w, bias, y, g, s);
}
