// K3: DCNv2 backward for Hopper (sm_90a), the per-(pixel, tap) part.
//
// Replaces ppyolo_tpu/ops/deform_conv_pallas.py::_dcn_bwd_pallas (kernel body
// _bwd_kernel).  The TPU kernel builds the one-hot selection matrix S once
// more and runs the col2im scatter as S^T @ d_sampled and the corner
// gradients as d_sampled @ x^T on the MXU, because the TPU has no fast
// scatter or gather.  Here the gathers are loads, and the scatter is turned
// into a gather too.  The two dense products around it stay outside, as in
// the JAX package (XLA einsums there, cuBLAS here): dm = g @ W^T before the
// kernel, dW = cols^T @ g after it.
//
// Per (output pixel, tap) and channel, with the fp32 corner indices and
// weights of K1 (dcn_fwd.cu) and _corner_tables:
//   sampled = sum_c w_c x[idx_c]               (fp32, from bf16 x)
//   dmod    = sum_C dm * sampled
//   dsamp   = dm * sigmoid(mask)
//   dx[idx_c] += w_c * dsamp                    (fp32)
//   dwgt_c  = sum_C dsamp * x[idx_c]
//   cols    = bf16(sampled * sigmoid(mask))     (the forward's columns, for dW)
//
// Bound on the H100: bytes.  At ppyolo_2x's stage-5 training shapes (batch 8,
// C = 512, 2888 output pixels) a launch reads dm (26.6 MB) and x (11.8 MB at
// 38x38/s2, 3.0 MB at 19x19/s1) and writes cols (26.6 MB) and the fp32 dx
// (23.7 / 5.9 MB): 26.5 us and 18.6 us at 3.35 TB/s, against ~6 flops a byte.
//
// Design (what it does about that).  The first version spent most of its
// time on the col2im scatter: 13.3 M float4 atomicAdds into L2 a launch.
// Two shared-memory forms of the scatter were built and measured first, and
// both lost to it (kernel_ab, H100 80GB HBM3 at 700 W, 38x38/s2, against
// 0.17 ms): Hopper has no native fp32 add on shared memory (atomicAdd there
// is a compare-and-swap loop, ATOMS.CAST.SPIN; 0.55 ms), and warps that own
// their channels exclusively, so that no atomics are needed, lose the
// coalescing of dm, x and cols (0.27 ms).  So the scatter becomes a gather:
// * dcn_bwd_kernel: one warp per (output pixel, tap), each lane 8 channels
//   of every 256 (16-byte loads and stores, 512 contiguous bytes a warp).
//   It computes the sampled column, dmod, the corner dots and cols, and
//   writes d_om (the vjp of _corner_tables: the offset gradient through the
//   bilinear weights of the valid corners and through the clamp with
//   jnp.clip's rule -- half the gradient exactly at a bound, none outside --
//   and the mask gradient dmod * m * (1 - m)) once per element.  For dx it
//   only bins: each valid corner takes a slot (one int atomic, issued before
//   the channel loop and used after it) in its dx pixel's bin of `cap`
//   (item, w_c * sigmoid(mask)) entries.
// * dcn_bwd_gather: one warp per (dx pixel, 256 channels) reads its bin 32
//   entries at a time, sums w * dm[item] in fp32 registers and writes the sum
//   to dx with one plain store: 4 x C/4 float atomics per (pixel, tap)
//   become one int atomic per corner, and dx needs no zero fill (every
//   element is written once).  A corner whose bin is full (more than `cap`
//   taps on one pixel) goes to an overflow list that its pixel's warp scans,
//   so any offsets are right.
// Left for a later PR: dm and cols (53 MB a launch) dominate the bytes, and
// the gather re-reads dm rows from L2 (~4 x 26.6 MB); the products that make
// dm and read cols could be fused with these kernels.
//
// Layouts: x NHWC bf16; om and d_om [N, oH, oW, 3*k2] in the layer's dtype
// T (bf16, or fp32 for an fp32 layer whose x the wrapper rounded to bf16);
// dm and cols [N*oH*oW, k2*C] bf16 (tap-major, then channel); dx NHWC fp32;
// cnt [N*H*W + 1] int32 (the bins' counts, then the overflow count), zeroed
// by the wrapper; bins [N*H*W, cap] int2 (item, weight bits); over
// [N*oH*oW*k2*4] int4 (pixel, item, weight bits, -).  Requires C % 8 == 0
// and 16-byte aligned x, dm, cols and dx (checked by the wrapper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_CH = 8;  // channels per lane: one 16-byte load
constexpr int STEP = 32 * LANE_CH;  // channels per warp step
constexpr unsigned FULL = 0xffffffffu;

struct Geom {
  int N, H, W, C, oH, oW, kh, kw, stride, pad, k2, cap;
};

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// d clip(v, lo, hi) / dv as jnp.clip (maximum, then minimum) gives it
__device__ __forceinline__ float clip_grad(float v, float lo, float hi) {
  if (v > lo && v < hi) return 1.f;
  return (v == lo || v == hi) ? 0.5f : 0.f;
}

// The corner geometry of output pixel (oh, ow) at `tap`: _corner_tables
// line by line, shared by the main kernel and the epilogue.
struct Corners {
  float ry, rx, ly, lx, mod;
  int yi[4], xi[4];
  float wgt[4];
  bool valid[4];
};

template <typename T>
__device__ __forceinline__ Corners corners(const T* o, int tap, int oh, int ow, const Geom& g) {
  Corners k;
  k.mod = 1.0f / (1.0f + expf(-to_f32(o[2 * g.k2 + tap])));
  const int ki = tap / g.kw, kj = tap % g.kw;
  k.ry = (float)(oh * g.stride - g.pad + ki) + to_f32(o[2 * tap]);
  k.rx = (float)(ow * g.stride - g.pad + kj) + to_f32(o[2 * tap + 1]);
  const float py = fminf(fmaxf(k.ry, -(float)g.pad), (float)(g.H - 1 + g.pad));
  const float px = fminf(fmaxf(k.rx, -(float)g.pad), (float)(g.W - 1 + g.pad));
  const float y0 = floorf(py), x0 = floorf(px);
  k.ly = py - y0;
  k.lx = px - x0;
  const float cw[4] = {(1.f - k.ly) * (1.f - k.lx), (1.f - k.ly) * k.lx,
                       k.ly * (1.f - k.lx), k.ly * k.lx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float yc = y0 + (float)(c / 2), xc = x0 + (float)(c % 2);
    k.valid[c] = yc >= 0.f && yc <= (float)(g.H - 1) && xc >= 0.f && xc <= (float)(g.W - 1);
    k.yi[c] = (int)fminf(fmaxf(yc, 0.f), (float)(g.H - 1));
    k.xi[c] = (int)fminf(fmaxf(xc, 0.f), (float)(g.W - 1));
    k.wgt[c] = k.valid[c] ? cw[c] : 0.f;
  }
  return k;
}


template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
dcn_bwd_kernel(const __nv_bfloat16* __restrict__ x, const T* __restrict__ om,
               const __nv_bfloat16* __restrict__ dm, T* __restrict__ d_om,
               __nv_bfloat16* __restrict__ cols, int* __restrict__ cnt, int2* __restrict__ bins,
               int4* __restrict__ over, Geom g) {
  const int lane = threadIdx.x % 32;
  const long long items = (long long)g.N * g.oH * g.oW * g.k2;
  const long long item = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= items) return;  // the whole warp leaves together
  const int tap = (int)(item % g.k2);
  const long long p = item / g.k2;  // n * oH * oW + oh * oW + ow
  const int n = (int)(p / ((long long)g.oH * g.oW));
  const int r = (int)(p % ((long long)g.oH * g.oW));
  const int oh = r / g.oW, ow = r % g.oW;
  const int om_c = 3 * g.k2;
  const Corners k = corners(om + p * om_c, tap, oh, ow, g);
  const size_t img = (size_t)n * g.H * g.W;
  int idx[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) idx[c] = k.yi[c] * g.W + k.xi[c];

  // lane c < 4 takes corner c's slot in its dx pixel's bin now; the slot is
  // used only after the channel loop, so the atomic's round trip overlaps it
  int slot = 0;
  size_t q = 0;
  float bw = 0.f;
  bool mine = false;  // this lane bins a valid corner
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (lane == c && k.valid[c]) {
      mine = true;
      q = img + idx[c];
      bw = k.wgt[c] * k.mod;
      slot = atomicAdd(cnt + q, 1);
    }
  }

  const __nv_bfloat16* xn = x + img * g.C;
  const size_t row = (size_t)item * g.C;  // dm / cols offset
  float dmod = 0.f, dwgt[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 8 * lane; c < g.C; c += STEP) {  // C % 8 == 0
    {
      float gv[LANE_CH], xv[4][LANE_CH], s[LANE_CH], ds[LANE_CH];
      unpack8(__ldg(reinterpret_cast<const uint4*>(dm + row + c)), gv);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        unpack8(__ldg(reinterpret_cast<const uint4*>(xn + (size_t)idx[cc] * g.C + c)), xv[cc]);
#pragma unroll
      for (int j = 0; j < LANE_CH; ++j) {
        float v = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) v += k.wgt[cc] * xv[cc][j];
        s[j] = v;
        dmod += gv[j] * v;
        ds[j] = gv[j] * k.mod;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < LANE_CH; ++j) a += ds[j] * xv[cc][j];
        dwgt[cc] += a;
      }
      uint4 packed;
      __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pk[j] = __floats2bfloat162_rn(s[2 * j] * k.mod, s[2 * j + 1] * k.mod);
      *reinterpret_cast<uint4*>(cols + row + c) = packed;
    }
  }

  if (mine) {
    if (slot < g.cap) {
      bins[q * g.cap + slot] = make_int2((int)item, __float_as_int(bw));
    } else {  // the bin is full: the overflow list (count in cnt[N*H*W])
      const int o = atomicAdd(cnt + (size_t)g.N * g.H * g.W, 1);
      over[o] = make_int4((int)q, (int)item, __float_as_int(bw), 0);
    }
  }

  dmod = warp_sum(dmod);
#pragma unroll
  for (int c = 0; c < 4; ++c) dwgt[c] = warp_sum(dwgt[c]);
  if (lane == 0) {
    // vjp of wgt_c = cw_c(ly, lx) * valid_c, ly = clip(ry) - floor(.), ...
    float d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = k.valid[c] ? dwgt[c] : 0.f;
    const float dly = -(1.f - k.lx) * d[0] - k.lx * d[1] + (1.f - k.lx) * d[2] + k.lx * d[3];
    const float dlx = -(1.f - k.ly) * d[0] + (1.f - k.ly) * d[1] - k.ly * d[2] + k.ly * d[3];
    const float lo = -(float)g.pad;
    T* o = d_om + p * om_c;
    store_out(o + 2 * tap, dly * clip_grad(k.ry, lo, (float)(g.H - 1 + g.pad)));
    store_out(o + 2 * tap + 1, dlx * clip_grad(k.rx, lo, (float)(g.W - 1 + g.pad)));
    store_out(o + 2 * g.k2 + tap, dmod * k.mod * (1.f - k.mod));
  }
}

// acc += w * dm[item, c .. c + 7]
__device__ __forceinline__ void accumulate(float (&acc)[LANE_CH], const __nv_bfloat16* dm,
                                           int item, float w, int c, bool c_ok, int C) {
  if (!c_ok) return;
  float v[LANE_CH];
  unpack8(__ldg(reinterpret_cast<const uint4*>(dm + (size_t)item * C + c)), v);
#pragma unroll
  for (int j = 0; j < LANE_CH; ++j) acc[j] += w * v[j];
}

// dx[q] = sum over q's bin of w * dm[item], one warp per (dx pixel, STEP
// channels), fp32 in registers; the bin's entries are loaded 32 at a time
// and handed round with shuffles.  A pixel whose bin overflowed also scans
// the overflow list for its entries.  Every dx element is written, once.
__global__ void __launch_bounds__(THREADS)
dcn_bwd_gather(const __nv_bfloat16* __restrict__ dm, const int* __restrict__ cnt,
               const int2* __restrict__ bins, const int4* __restrict__ over,
               float* __restrict__ dx, Geom g) {
  const int lane = threadIdx.x % 32;
  const int steps = (g.C + STEP - 1) / STEP;
  const long long wid = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long pixels = (long long)g.N * g.H * g.W;
  const long long q = wid / steps;
  if (q >= pixels) return;
  const int c = (int)(wid % steps) * STEP + 8 * lane;
  const bool c_ok = c < g.C;  // C % 8 == 0
  const int total = cnt[q];
  const int ne = min(total, g.cap);
  float acc[LANE_CH];
#pragma unroll
  for (int j = 0; j < LANE_CH; ++j) acc[j] = 0.f;
  for (int e0 = 0; e0 < ne; e0 += 32) {
    const int2 b = e0 + lane < ne ? bins[q * g.cap + e0 + lane] : make_int2(0, 0);
    const int m = min(32, ne - e0);
#pragma unroll 4
    for (int i = 0; i < m; ++i)
      accumulate(acc, dm, __shfl_sync(FULL, b.x, i), __int_as_float(__shfl_sync(FULL, b.y, i)),
                 c, c_ok, g.C);
  }
  if (total > g.cap) {  // rare: more than cap corners on this pixel
    const int no = cnt[pixels];
    for (int e0 = 0; e0 < no; e0 += 32) {
      int dest = -1, item = 0, wbits = 0;
      if (e0 + lane < no) {
        const int4 o = over[e0 + lane];
        dest = o.x;
        item = o.y;
        wbits = o.z;
      }
      for (unsigned mine = __ballot_sync(FULL, dest == (int)q); mine; mine &= mine - 1) {
        const int i = __ffs(mine) - 1;
        accumulate(acc, dm, __shfl_sync(FULL, item, i), __int_as_float(__shfl_sync(FULL, wbits, i)),
                   c, c_ok, g.C);
      }
    }
  }
  if (!c_ok) return;
  float4* d = reinterpret_cast<float4*>(dx + q * g.C + c);
  d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <typename T>
int launch(const void* x, const void* om, const void* dm, void* dx, void* d_om, void* cols,
           void* cnt, void* bins, void* over, const Geom& g, cudaStream_t stream) {
  const long long items = (long long)g.N * g.oH * g.oW * g.k2;
  dcn_bwd_kernel<T><<<(unsigned)((items + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const T*>(om),
      static_cast<const __nv_bfloat16*>(dm), static_cast<T*>(d_om),
      static_cast<__nv_bfloat16*>(cols), static_cast<int*>(cnt), static_cast<int2*>(bins),
      static_cast<int4*>(over), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = (long long)g.N * g.H * g.W * ((g.C + STEP - 1) / STEP);
  dcn_bwd_gather<<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dm), static_cast<const int*>(cnt),
      static_cast<const int2*>(bins), static_cast<const int4*>(over), static_cast<float*>(dx),
      g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks that fit one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the main kernel (bf16 om) for which = 0, of the gather for which = 1, or
// minus the CUDA error.
extern "C" int dcn_bwd_blocks_per_sm(int which) {
  int blocks = 0;
  const cudaError_t err =
      which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, dcn_bwd_kernel<__nv_bfloat16>, THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dcn_bwd_gather,
                                                                 THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// om and d_om are fp32 when is_f32, else bf16; x, dm and cols are bf16, dx
// fp32.  cnt [N*H*W + 1] (zeroed), bins [N*H*W, cap] and over [N*oH*oW*k2*4]
// are the dx pixels' bins, the bins' counts and the overflow list.
extern "C" int dcn_bwd_launch(const void* x, const void* om, const void* dm, void* dx,
                              void* d_om, void* cols, void* cnt, void* bins, void* over,
                              int cap,
                              int is_f32, int N, int H, int W, int C, int oH, int oW, int kh,
                              int kw, int stride, int pad, void* stream) {
  Geom g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.C = C;
  g.oH = oH;
  g.oW = oW;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.pad = pad;
  g.k2 = kh * kw;
  g.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float>(x, om, dm, dx, d_om, cols, cnt, bins, over, g, s)
                : launch<__nv_bfloat16>(x, om, dm, dx, d_om, cols, cnt, bins, over, g, s);
}
