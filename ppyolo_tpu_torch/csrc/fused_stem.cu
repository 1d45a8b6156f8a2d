// Fused eval-mode ResNet-vd deep stem for Hopper (sm_90a).
//
// Replaces ppyolo_tpu/ops/stem_pallas.py::fused_stem (kernel body
// _stem_kernel): conv1_1 3->32 3x3/s2, conv1_2 32->32 3x3, conv1_3 32->64 3x3
// (each with its BN folded into weight and fp32 bias, then relu, fp32
// accumulation and a bf16 round) and the 3x3/s2/p1 max-pool, in one kernel.
// The TPU kernel packs pixels into 128-lane rows to feed its MXU; here each
// block owns one image and a T x T tile of pooled outputs and keeps the whole
// receptive field in shared memory: the (4T+11)^2 x 3 input halo, the
// (2T+5)^2 x 32 conv1_1, (2T+3)^2 x 32 conv1_2 and (2T+1)^2 x 64 conv1_3 tiles
// (the halo is recomputed by neighbouring blocks), and all the weights.  Only
// the image is read and only the pooled [N, S/4, S/4, 64] map is written to
// device memory.
//
// A conv position outside the conv's output range is the next conv's zero
// padding and is stored as 0, not relu(bias) (the masks of stem_pallas.py
// lines 207-211, 234-236, 248-250).  The pool then pads with 0, which equals
// -inf padding because its input is post-relu.
//
// Bound on the H100: at batch 8 x 608^2 the three convs are 42.2 GFLOP against
// ~41 MB of traffic, so the arithmetic bounds it (43 us at the bf16
// tensor-core peak).  conv1_2 and conv1_3 (98% of the work) run on the
// tensor cores as implicit GEMMs straight out of the shared-memory tiles:
// 16 consecutive pixels of one tile row, at one tap, are a row-major 16 x 32
// bf16 matrix with leading dimension 32, so wmma loads them in place (a
// row's two 16-pixel fragments overlap when the tile is narrower than 32).
// conv1_1 (K = 27) stays fp32 FMA on the CUDA cores.  Not yet done: wgmma,
// asynchronous tile loads, more than one block per SM.
//
// Layouts: x NHWC bf16 [N, H, W, 3]; w1 fp32 [3][3][3][32]; w2 bf16
// [3][3][32][32], w3 bf16 [3][3][32][64] (HWIO); b1, b2, b3 fp32; y NHWC bf16
// [N, S4h, S4w, 64].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int T = 8;              // pooled outputs per block edge
constexpr int R3 = 2 * T + 1;     // conv1_3 tile edge
constexpr int R2 = 2 * T + 3;     // conv1_2 tile edge
constexpr int R1 = 2 * T + 5;     // conv1_1 tile edge
constexpr int R0 = 4 * T + 11;    // input tile edge
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

// Padded leading dimensions (elements) of the tiles the tensor cores read:
// a power-of-two row stride would put a fragment's 16 rows on the same
// shared-memory banks.  Multiples of 16 bytes, and 32-byte aligned rows for
// the activation tiles (a fragment may start at any pixel).
constexpr int ACT_LD = 48;                          // conv1_1 / conv1_2 tiles, 32 channels
constexpr int W2_LD = 32 + 8, W3_LD = 64 + 8;       // weight rows [tap][ci][co]
constexpr int STAGE_LD = 16 + 4;

constexpr int align128(int b) { return (b + 127) / 128 * 128; }
constexpr int W2_BYTES = 9 * 32 * W2_LD * 2;        // bf16
constexpr int W3_BYTES = 9 * 32 * W3_LD * 2;
constexpr int STAGE_BYTES = WARPS * 16 * STAGE_LD * 4;  // per-warp fp32 accumulator tile
constexpr int IN_BYTES = align128(R0 * R0 * 3 * 2);
constexpr int C1_BYTES = align128(R1 * R1 * ACT_LD * 2);
constexpr int C2_BYTES = align128(R2 * R2 * ACT_LD * 2);
constexpr int C3_BYTES = align128(R3 * R3 * 64 * 2);
// conv1_3's tile reuses the input + conv1_1 region, dead by then
constexpr int ACT_A_BYTES = (IN_BYTES + C1_BYTES) > C3_BYTES ? (IN_BYTES + C1_BYTES) : C3_BYTES;
constexpr int W1_N = 27 * 32, B_N = 128;
constexpr int OFF_W3 = W2_BYTES;
constexpr int OFF_STAGE = OFF_W3 + W3_BYTES;
constexpr int OFF_ACT = OFF_STAGE + STAGE_BYTES;
constexpr int OFF_C2 = OFF_ACT + ACT_A_BYTES;
constexpr int OFF_W1 = OFF_C2 + C2_BYTES;
constexpr int SMEM_BYTES = OFF_W1 + (W1_N + B_N) * 4;
static_assert(SMEM_BYTES <= 232448, "stem tile exceeds shared memory");
static_assert(OFF_W3 % 128 == 0 && OFF_STAGE % 128 == 0 && OFF_ACT % 128 == 0 &&
              OFF_C2 % 128 == 0 && OFF_W1 % 128 == 0, "shared-memory regions misaligned");

// conv1_1 on the CUDA cores: out[OUT_W^2][OUT_LD] from in[IN_W^2][CIN], fp32
// FMA.  (oy0, ox0) is the absolute output position of tile element (0, 0);
// positions outside [0, OH) x [0, OW) are stored as 0 (also in conv_wmma).
template <int CIN, int COUT, int STRIDE, int IN_W, int OUT_W, int OUT_LD>
__device__ __forceinline__ void conv_layer(const __nv_bfloat16* __restrict__ in,
                                           __nv_bfloat16* __restrict__ out,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int oy0, int ox0, int OH, int OW) {
  constexpr int G = COUT / 8;
  for (int item = threadIdx.x; item < OUT_W * OUT_W * G; item += THREADS) {
    const int g = item % G, pix = item / G;
    const int ry = pix / OUT_W, rx = pix % OUT_W;
    const int ay = oy0 + ry, ax = ox0 + rx;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (ay >= 0 && ay < OH && ax >= 0 && ax < OW) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const __nv_bfloat16* ip = in + ((ry * STRIDE + ky) * IN_W + rx * STRIDE + kx) * CIN;
          const float* wp = w + (ky * 3 + kx) * CIN * COUT + g * 8;
#pragma unroll 8
          for (int ci = 0; ci < CIN; ++ci) {
            const float a = __bfloat162float(ip[ci]);
            const float4 w0 = *reinterpret_cast<const float4*>(wp + ci * COUT);
            const float4 w1 = *reinterpret_cast<const float4*>(wp + ci * COUT + 4);
            acc[0] += a * w0.x; acc[1] += a * w0.y; acc[2] += a * w0.z; acc[3] += a * w0.w;
            acc[4] += a * w1.x; acc[5] += a * w1.y; acc[6] += a * w1.z; acc[7] += a * w1.w;
          }
        }
      }
      __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) pk[j] = __float2bfloat16(fmaxf(acc[j] + b[g * 8 + j], 0.f));
    }
    *reinterpret_cast<uint4*>(out + pix * OUT_LD + g * 8) = packed;
  }
}

// A 3x3/s1 conv on the tensor cores: out[OUT_W^2][OUT_LD] from
// in[IN_W^2][ACT_LD] (32 channels used), weights w[9*32][W_LD],
// IN_W = OUT_W + 2, 16 <= OUT_W < 32.  A warp task is 16 pixels of one tile
// row (columns [0, 16) or [OUT_W-16, OUT_W)) x 16 output channels, summed
// over 9 taps x 2 chunks of 16 input channels; the fp32 tile goes through the
// warp's staging buffer for bias, relu, the range mask and the bf16 round.
template <int COUT, int W_LD, int IN_W, int OUT_W, int OUT_LD>
__device__ __forceinline__ void conv_wmma(const __nv_bfloat16* __restrict__ in,
                                          __nv_bfloat16* __restrict__ out,
                                          const __nv_bfloat16* __restrict__ w,
                                          const float* __restrict__ b,
                                          float* __restrict__ stage,
                                          int oy0, int ox0, int OH, int OW) {
  static_assert(IN_W == OUT_W + 2 && OUT_W >= 16 && OUT_W < 32, "tile shape");
  constexpr int NF = COUT / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < OUT_W * 2 * NF; t += WARPS) {
    const int nf = t % NF, half = (t / NF) % 2, ry = t / (2 * NF);
    const int rx0 = half ? OUT_W - 16 : 0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const __nv_bfloat16* a = in + ((ry + tap / 3) * IN_W + rx0 + tap % 3) * ACT_LD;
#pragma unroll
      for (int kc = 0; kc < 32; kc += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + kc, ACT_LD);
        wmma::load_matrix_sync(fb, w + (tap * 32 + kc) * W_LD + nf * 16, W_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(stage, acc, STAGE_LD, wmma::mem_row_major);
    __syncwarp();
    const int r = lane / 2, c0 = (lane % 2) * 8;
    const int rx = rx0 + r, ay = oy0 + ry, ax = ox0 + rx;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (ay >= 0 && ay < OH && ax >= 0 && ax < OW) {
      __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pk[j] = __float2bfloat16(fmaxf(stage[r * STAGE_LD + c0 + j] + b[nf * 16 + c0 + j], 0.f));
    }
    *reinterpret_cast<uint4*>(out + (ry * OUT_W + rx) * OUT_LD + nf * 16 + c0) = packed;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
fused_stem_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                  const float* __restrict__ b3, __nv_bfloat16* __restrict__ y,
                  int H, int W, int S2h, int S2w, int S4h, int S4w, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sw2 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw3 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_W3);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE) + (threadIdx.x / 32) * 16 * STAGE_LD;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + OFF_ACT);
  __nv_bfloat16* s_c1 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_ACT + IN_BYTES);
  __nv_bfloat16* s_c3 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_ACT);
  __nv_bfloat16* s_c2 = reinterpret_cast<__nv_bfloat16*>(smem + OFF_C2);
  float* sw1 = reinterpret_cast<float*>(smem + OFF_W1);
  float* sb = sw1 + W1_N;  // b1 | b2 | b3

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int py0 = (blockIdx.x / tiles_x) * T, px0 = (blockIdx.x % tiles_x) * T;

  // weight rows [tap*32 + ci] of 32 / 64 bf16 into padded rows, 16 bytes a copy
  for (int i = tid; i < 9 * 32 * 4; i += THREADS)
    *reinterpret_cast<uint4*>(sw2 + (i / 4) * W2_LD + (i % 4) * 8) =
        __ldg(reinterpret_cast<const uint4*>(w2) + i);
  for (int i = tid; i < 9 * 32 * 8; i += THREADS)
    *reinterpret_cast<uint4*>(sw3 + (i / 8) * W3_LD + (i % 8) * 8) =
        __ldg(reinterpret_cast<const uint4*>(w3) + i);
  for (int i = tid; i < W1_N / 4; i += THREADS)
    reinterpret_cast<float4*>(sw1)[i] = __ldg(reinterpret_cast<const float4*>(w1) + i);
  if (tid < 32) sb[tid] = b1[tid];
  else if (tid < 64) sb[tid] = b2[tid - 32];
  else if (tid < 128) sb[tid] = b3[tid - 64];

  // input halo: image rows 4*py0-7 .. +R0, zeros outside the image
  const int iy0 = 4 * py0 - 7, ix0 = 4 * px0 - 7;
  const __nv_bfloat16* xn = x + (size_t)n * H * W * 3;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < R0 * R0; i += THREADS) {
    const int iy = iy0 + i / R0, ix = ix0 + i % R0;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const __nv_bfloat16* src = xn + ((size_t)iy * W + ix) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) s_in[i * 3 + c] = inside ? src[c] : zero;
  }
  __syncthreads();

  conv_layer<3, 32, 2, R0, R1, ACT_LD>(s_in, s_c1, sw1, sb, 2 * py0 - 3, 2 * px0 - 3, S2h, S2w);
  __syncthreads();
  conv_wmma<32, W2_LD, R1, R2, ACT_LD>(s_c1, s_c2, sw2, sb + 32, stage, 2 * py0 - 2,
                                       2 * px0 - 2, S2h, S2w);
  __syncthreads();
  conv_wmma<64, W3_LD, R2, R3, 64>(s_c2, s_c3, sw3, sb + 64, stage, 2 * py0 - 1,
                                   2 * px0 - 1, S2h, S2w);
  __syncthreads();

  // max-pool 3x3/s2: pooled (i, j) reads conv1_3 tile rows 2i..2i+2
  for (int item = tid; item < T * T * 8; item += THREADS) {
    const int g = item % 8, pix = item / 8;
    const int i = pix / T, j = pix % T;
    const int py = py0 + i, px = px0 + j;
    if (py >= S4h || px >= S4w) continue;
    float m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = 0.f;  // inputs are >= 0
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            s_c3 + ((2 * i + dy) * R3 + 2 * j + dx) * 64 + g * 8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], __bfloat162float(e[k]));
      }
    }
    uint4 packed;
    __nv_bfloat16* pk = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int k = 0; k < 8; ++k) pk[k] = __float2bfloat16(m[k]);
    *reinterpret_cast<uint4*>(y + (((size_t)n * S4h + py) * S4w + px) * 64 + g * 8) = packed;
  }
}

}  // namespace

extern "C" int fused_stem_smem_bytes() { return SMEM_BYTES; }

extern "C" int fused_stem_launch(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* w3,
                                 const void* b3, void* y, int N, int H, int W,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S2h = (H - 1) / 2 + 1, S2w = (W - 1) / 2 + 1;
  const int S4h = (S2h - 1) / 2 + 1, S4w = (S2w - 1) / 2 + 1;
  const int tiles_y = (S4h + T - 1) / T, tiles_x = (S4w + T - 1) / T;
  dim3 grid(tiles_x * tiles_y, N);
  fused_stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<__nv_bfloat16*>(y), H, W, S2h, S2w,
      S4h, S4w, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
