// K7: train-mode BatchNorm with its activation, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves batch_norm to XLA
// (ppyolo_tpu/ops/conv.py::batch_norm), which fuses its elementwise passes
// itself.  The port's plain form (ops/module.py::BatchNorm._forward_train,
// then the activation) runs in eager PyTorch as about eight full-size passes
// forward and nine backward, mostly in fp32: some 130 bytes an element.
//
// What bounds it: bytes.  Per element the work is a few flops; the least
// traffic is one read of x for the statistics, one read of x and one write of
// y for the output, one read of dy and x for the backward's sums, and one
// read of dy and x and one write of dx: 8 reads and writes, 16 B an element
// in bf16 (32 in fp32).  The design moves only those:
//
// * The activation is channels_last NCHW, read as [R = N*H*W, C] rows.  A
//   block covers a span of up to 32 16-byte vectors of channels (256 bf16 or
//   128 fp32 channels) and a slice of rows; a thread loads 16 bytes at a time,
//   neighbouring threads neighbouring vectors of a row, four rows in flight.
//   A C that is no multiple of a vector (or a row not 16-byte aligned) takes
//   the same kernels one element a thread (VEC = 1).
// * Per-channel sums in fp32, in a fixed order: each thread over its rows in
//   order, the block's row threads in order in shared memory, one partial row
//   of [2C] per row block in device memory, and bn_train_reduce summing the
//   partials in order.  No float atomics: the same bits every run, eager or
//   replayed from a CUDA graph.  The partials are [row_blocks, 2C] fp32,
//   a few hundred KB at most.
// * One wave: a pass launches at most two blocks an SM (spans x row_blocks),
//   each looping over its rows; per-block set-up (the coefficients, the
//   partials' sums in shared memory) and a second wave's tail cost more than
//   the loads more blocks would overlap (a step's layers: 5.89 ms at 264
//   blocks on 132 SMs, 7.67 at 1024).
// * Each pass over the data derives the per-channel coefficients from the
//   [2C] sums in a prologue (m = S1 / n, v = max(S2 / n - m^2, 0), k =
//   rsqrt(v + eps) * weight; the mean and the square rounded apart, as the
//   plain form rounds them), so sync-BN's all-reduce of the [2C] sums fits
//   between the passes and the backward recomputes them bitwise.  The apply
//   pass's first row block of each span also updates the running statistics
//   in place (unbiased var, momentum), unless the caller says not to (a
//   recompute under remat).
// * y = (x - m) * k + bias in fp32 (one FMA, as torch's addcmul), rounded to
//   x's dtype, then the activation (relu, or leaky 0.1) of the rounded value
//   and a second rounding: the plain form's order.
// * The backward recomputes y from x with the same arithmetic for the
//   activation's mask instead of reading the output (2 B an element less),
//   g = dy * act'(y) (leaky's 0.1 * dy rounded to dy's dtype, as torch's
//   leaky_relu_backward writes it), sums g and g * (x - m) per channel, and
//   writes dx = k * (g - A / n) - (x - m) * c * B * weight * (v + eps)^(-3/2) / n
//   with c = 1 where E[x^2] - m^2 > 0, 1/2 at a tie and 0 where it is
//   clamped (the gradient torch.maximum gives).  The reduce of the backward
//   also writes dweight = B * rsqrt(v + eps) and dbias = A in the
//   parameters' dtype from the rank's own sums.
//
// Launch plan (ops/bn_train.py::geometry): grid (spans, row_blocks), 256
// threads; a thread's channel vector is threadIdx.x % tc, its row
// threadIdx.x / tc, with tc = min(C / VEC, 32).  Parameters (weight, bias)
// are bf16 or fp32 (param_bf16), the running statistics fp32, the sums fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SPAN = 256;   // channels a block covers: 32 vectors of 8 bf16
constexpr int UNROLL = 4;       // rows a thread has in flight
constexpr int RED_LANES = 32;   // bn_train_reduce: columns a block
constexpr int RED_GROUPS = 32;  // and row groups summed apart, then in order

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back (the identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

__device__ __forceinline__ float param(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// The statistics of channel c from the [2C] sums over n values: mean m, the
// clamped variance v, the unclamped d = E[x^2] - m^2 and rsqrt(v + eps).
struct Stats { float m, v, d, invstd; };

__device__ __forceinline__ Stats stats_of(const float* sums, int C, int c, float n, float eps) {
  Stats s;
  s.m = __fdiv_rn(sums[c], n);
  const float msq = __fdiv_rn(sums[C + c], n);
  s.d = __fsub_rn(msq, __fmul_rn(s.m, s.m));
  s.v = fmaxf(s.d, 0.f);
  s.invstd = rsqrtf(__fadd_rn(s.v, eps));
  return s;
}

// y = (x - m) * k + b rounded to T, then the activation and T again
template <typename T>
__device__ __forceinline__ float normalized(float x, float m, float k, float b) {
  return round_to<T>(__fmaf_rn(__fsub_rn(x, m), k, b));
}

template <typename T>
__device__ __forceinline__ float activated(float y, int act) {
  if (act == ACT_RELU) return y < 0.f ? 0.f : y;
  if (act == ACT_LEAKY) return y > 0.f ? y : round_to<T>(__fmul_rn(y, 0.1f));
  return y;
}

// dy * act'(y), y the rounded pre-activation value
template <typename T>
__device__ __forceinline__ float act_grad(float dy, float y, int act) {
  if (act == ACT_RELU) return y > 0.f ? dy : 0.f;
  if (act == ACT_LEAKY) return y > 0.f ? dy : round_to<T>(__fmul_rn(dy, 0.1f));
  return dy;
}

// A thread's place in a block of the data passes.
struct Tile {
  int tc, tr, cx, ry, span, c_base, c0;
  long long r_begin, r_end;
  bool active;
};

template <int V>
__device__ __forceinline__ Tile tile(int R, int C, int rows_per_block) {
  Tile t;
  t.tc = min(C / V, 32);
  t.tr = THREADS / t.tc;
  t.cx = threadIdx.x % t.tc;
  t.ry = threadIdx.x / t.tc;
  t.span = t.tc * V;
  t.c_base = blockIdx.x * t.span;
  t.c0 = t.c_base + t.cx * V;
  t.r_begin = (long long)blockIdx.y * rows_per_block;
  t.r_end = min((long long)R, t.r_begin + rows_per_block);
  t.active = t.ry < t.tr && t.c0 < C;
  return t;
}

// The block's per-thread fp32 sums a[V], b[V] summed over its row threads in
// order and written as partial row blockIdx.y of [row_blocks, 2C]: a at c, b
// at C + c.
template <int V>
__device__ __forceinline__ void block_partials(const Tile& t, int C, const float (&a)[V],
                                               const float (&b)[V], float* part) {
  __shared__ float red[2][THREADS * V];
  if (t.ry < t.tr) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[0][t.ry * t.span + t.cx * V + j] = a[j];
      red[1][t.ry * t.span + t.cx * V + j] = b[j];
    }
  }
  __syncthreads();
  float* row = part + (size_t)blockIdx.y * 2 * C;
  for (int i = threadIdx.x; i < 2 * t.span; i += THREADS) {
    const int which = i / t.span, j = i % t.span, c = t.c_base + j;
    if (c >= C) continue;
    float s = 0.f;
    for (int r = 0; r < t.tr; ++r) s += red[which][r * t.span + j];
    row[which * C + c] = s;
  }
}

// Per-channel m, k, b of the block's span into shared memory, and into
// registers for the thread's vector.
template <int V>
__device__ __forceinline__ void coefficients(const Tile& t, const float* sums, const void* weight,
                                             const void* bias, int pbf16, int C, float n,
                                             float eps, float (&m)[V], float (&k)[V],
                                             float (&b)[V]) {
  __shared__ float sm[MAX_SPAN], sk[MAX_SPAN], sb[MAX_SPAN];
  for (int j = threadIdx.x; j < t.span; j += THREADS) {
    const int c = t.c_base + j;
    if (c >= C) continue;
    const Stats s = stats_of(sums, C, c, n, eps);
    sm[j] = s.m;
    sk[j] = __fmul_rn(s.invstd, param(weight, pbf16, c));
    sb[j] = param(bias, pbf16, c);
  }
  __syncthreads();
  if (t.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = sm[t.cx * V + j];
      k[j] = sk[t.cx * V + j];
      b[j] = sb[t.cx * V + j];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_train_fwd_stats(const T* __restrict__ x, float* __restrict__ part, int R, int C,
                   int rows_per_block) {
  const Tile t = tile<V>(R, C, rows_per_block);
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (t.active) {
    for (long long r = t.r_begin + t.ry; r < t.r_end; r += UNROLL * t.tr) {
      Pack<T, V> p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * t.tr;
        if (rr < t.r_end) p[u] = load<T, V>(x + rr * C + t.c0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (long long)u * t.tr >= t.r_end) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = to_f(p[u].v[j]);
          s[j] += v;
          q[j] = __fmaf_rn(v, v, q[j]);
        }
      }
    }
  }
  block_partials<V>(t, C, s, q, part);
}

// out[col] = sum over rows of part[row][col], in a fixed order.  With dweight
// set (the backward), also dbias[c] = out[c] and dweight[c] = out[C + c] *
// rsqrt(v + eps), v from the forward's sums, in the parameters' dtype.
__global__ void __launch_bounds__(RED_LANES * RED_GROUPS)
bn_train_reduce(const float* __restrict__ part, float* __restrict__ out, int rows, int cols,
                const float* __restrict__ fwd_sums, void* dweight, void* dbias, int pbf16,
                int C, float n, float eps) {
  __shared__ float sh[RED_GROUPS][RED_LANES + 1];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int col = blockIdx.x * RED_LANES + lane;
  float s = 0.f;
  if (col < cols) {
#pragma unroll 4
    for (int r = g; r < rows; r += RED_GROUPS) s += part[(size_t)r * cols + col];
  }
  sh[g][lane] = s;
  __syncthreads();
  if (g != 0 || col >= cols) return;
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < RED_GROUPS; ++i) tot += sh[i][lane];
  out[col] = tot;
  if (dweight == nullptr) return;
  float v = tot;
  void* dst = dbias;
  int c = col;
  if (col >= C) {
    c = col - C;
    v = __fmul_rn(tot, stats_of(fwd_sums, C, c, n, eps).invstd);
    dst = dweight;
  }
  if (pbf16)
    static_cast<__nv_bfloat16*>(dst)[c] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(dst)[c] = v;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_train_fwd_apply(const T* __restrict__ x, const float* __restrict__ sums, const void* weight,
                   const void* bias, int pbf16, float* running_mean, float* running_var,
                   T* __restrict__ y, int R, int C, int rows_per_block, float n, float eps,
                   float unbias, float keep, float momentum, int update, int act) {
  const Tile t = tile<V>(R, C, rows_per_block);
  if (update && blockIdx.y == 0) {
    // running = (1 - momentum) * running + momentum * stat, each product
    // rounded, as the plain form's expression
    for (int j = threadIdx.x; j < t.span; j += THREADS) {
      const int c = t.c_base + j;
      if (c >= C) continue;
      const Stats s = stats_of(sums, C, c, n, eps);
      running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(momentum, s.m));
      running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                                 __fmul_rn(momentum, __fmul_rn(s.v, unbias)));
    }
  }
  float m[V], k[V], b[V];
  coefficients<V>(t, sums, weight, bias, pbf16, C, n, eps, m, k, b);
  if (!t.active) return;
  for (long long r = t.r_begin + t.ry; r < t.r_end; r += UNROLL * t.tr) {
    Pack<T, V> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * t.tr;
      if (rr < t.r_end) p[u] = load<T, V>(x + rr * C + t.c0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * t.tr;
      if (rr >= t.r_end) continue;
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = from_f<T>(activated<T>(normalized<T>(to_f(p[u].v[j]), m[j], k[j], b[j]), act));
      store<T, V>(y + rr * C + t.c0, o);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_train_bwd_stats(const T* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ sums, const void* weight, const void* bias,
                   int pbf16, float* __restrict__ part, int R, int C, int rows_per_block,
                   float n, float eps, int act) {
  const Tile t = tile<V>(R, C, rows_per_block);
  float m[V], k[V], b[V], sg[V], sgx[V];
  coefficients<V>(t, sums, weight, bias, pbf16, C, n, eps, m, k, b);
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sgx[j] = 0.f;
  if (t.active) {
    for (long long r = t.r_begin + t.ry; r < t.r_end; r += UNROLL * t.tr) {
      Pack<T, V> px[UNROLL], pg[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * t.tr;
        if (rr < t.r_end) {
          px[u] = load<T, V>(x + rr * C + t.c0);
          pg[u] = load<T, V>(dy + rr * C + t.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (long long)u * t.tr >= t.r_end) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = to_f(px[u].v[j]);
          const float g = act_grad<T>(to_f(pg[u].v[j]), normalized<T>(xv, m[j], k[j], b[j]), act);
          sg[j] += g;
          sgx[j] = __fmaf_rn(g, __fsub_rn(xv, m[j]), sgx[j]);
        }
      }
    }
  }
  block_partials<V>(t, C, sg, sgx, part);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_train_bwd_dx(const T* __restrict__ dy, const T* __restrict__ x,
                const float* __restrict__ sums, const float* __restrict__ gsums,
                const void* weight, const void* bias, int pbf16, T* __restrict__ dx, int R,
                int C, int rows_per_block, float n, float eps, int act) {
  const Tile t = tile<V>(R, C, rows_per_block);
  __shared__ float sa[MAX_SPAN], sq[MAX_SPAN];
  for (int j = threadIdx.x; j < t.span; j += THREADS) {
    const int c = t.c_base + j;
    if (c >= C) continue;
    const Stats s = stats_of(sums, C, c, n, eps);
    const float clamp = s.d > 0.f ? 1.f : (s.d == 0.f ? 0.5f : 0.f);
    const float s3 = __fmul_rn(__fmul_rn(s.invstd, s.invstd), s.invstd);
    sa[j] = __fdiv_rn(gsums[c], n);
    sq[j] = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(clamp, gsums[C + c]),
                                          param(weight, pbf16, c)), s3), n);
  }
  float m[V], k[V], b[V];
  coefficients<V>(t, sums, weight, bias, pbf16, C, n, eps, m, k, b);   // syncs
  if (!t.active) return;
  float a[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = sa[t.cx * V + j];
    q[j] = sq[t.cx * V + j];
  }
  for (long long r = t.r_begin + t.ry; r < t.r_end; r += UNROLL * t.tr) {
    Pack<T, V> px[UNROLL], pg[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * t.tr;
      if (rr < t.r_end) {
        px[u] = load<T, V>(x + rr * C + t.c0);
        pg[u] = load<T, V>(dy + rr * C + t.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * t.tr;
      if (rr >= t.r_end) continue;
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xv = to_f(px[u].v[j]);
        const float g = act_grad<T>(to_f(pg[u].v[j]), normalized<T>(xv, m[j], k[j], b[j]), act);
        const float xm = __fsub_rn(xv, m[j]);
        o.v[j] = from_f<T>(__fmaf_rn(k[j], __fsub_rn(g, a[j]), -__fmul_rn(xm, q[j])));
      }
      store<T, V>(dx + rr * C + t.c0, o);
    }
  }
}

bool bad_geometry(int R, int C, int vec, int spans, int row_blocks, int rows_per_block) {
  if (R < 1 || C < 1 || spans < 1 || row_blocks < 1 || rows_per_block < 1) return true;
  if (C % vec) return true;
  const int tc = C / vec < 32 ? C / vec : 32;
  if (tc * vec > MAX_SPAN) return true;
  if ((long long)spans * tc * vec < C || (long long)row_blocks * rows_per_block < R) return true;
  return false;
}

}  // namespace

// Each launch returns the CUDA error of its launch (0 on success).  x, dy, y
// and dx are [R, C] rows (channels_last NCHW), bf16 (bf16 = 1) or fp32;
// vec is 16 / sizeof(element) or 1; (spans, row_blocks, rows_per_block) from
// ops/bn_train.py::geometry.  part is [row_blocks, 2C] fp32.

extern "C" int bn_train_fwd_stats_launch(const void* x, void* part, int bf16, int R, int C,
                                         int vec, int spans, int row_blocks, int rows_per_block,
                                         void* stream) {
  if (bad_geometry(R, C, vec, spans, row_blocks, rows_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(spans, row_blocks);
  float* p = static_cast<float*>(part);
  if (bf16 && vec == 8)
    bn_train_fwd_stats<__nv_bfloat16, 8><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), p, R, C, rows_per_block);
  else if (bf16 && vec == 1)
    bn_train_fwd_stats<__nv_bfloat16, 1><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), p, R, C, rows_per_block);
  else if (!bf16 && vec == 4)
    bn_train_fwd_stats<float, 4><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), p, R, C, rows_per_block);
  else if (!bf16 && vec == 1)
    bn_train_fwd_stats<float, 1><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), p, R, C, rows_per_block);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out [cols] = the column sums of part [rows, cols].  dweight and dbias null
// in the forward; in the backward cols = 2C, fwd_sums the forward's [2C].
extern "C" int bn_train_reduce_launch(const void* part, void* out, int rows, int cols,
                                      const void* fwd_sums, void* dweight, void* dbias,
                                      int param_bf16, int C, float n, float eps, void* stream) {
  if (rows < 1 || cols < 1 || (dweight != nullptr && cols != 2 * C))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(RED_LANES, RED_GROUPS);
  const dim3 grid((cols + RED_LANES - 1) / RED_LANES);
  bn_train_reduce<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), rows, cols,
      static_cast<const float*>(fwd_sums), dweight, dbias, param_bf16, C, n, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_train_fwd_apply_launch(const void* x, const void* sums, const void* weight,
                                         const void* bias, void* running_mean,
                                         void* running_var, void* y, int bf16, int param_bf16,
                                         int R, int C, int vec, int spans, int row_blocks,
                                         int rows_per_block, float n, float eps, float unbias,
                                         float keep, float momentum, int update, int act,
                                         void* stream) {
  if (bad_geometry(R, C, vec, spans, row_blocks, rows_per_block) || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(spans, row_blocks);
  const float* sm = static_cast<const float*>(sums);
  float* rm = static_cast<float*>(running_mean);
  float* rv = static_cast<float*>(running_var);
#define BN_APPLY(T, V)                                                                      \
  bn_train_fwd_apply<T, V><<<grid, THREADS, 0, s>>>(                                        \
      static_cast<const T*>(x), sm, weight, bias, param_bf16, rm, rv, static_cast<T*>(y), R, \
      C, rows_per_block, n, eps, unbias, keep, momentum, update, act)
  if (bf16 && vec == 8) BN_APPLY(__nv_bfloat16, 8);
  else if (bf16 && vec == 1) BN_APPLY(__nv_bfloat16, 1);
  else if (!bf16 && vec == 4) BN_APPLY(float, 4);
  else if (!bf16 && vec == 1) BN_APPLY(float, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef BN_APPLY
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_train_bwd_stats_launch(const void* dy, const void* x, const void* sums,
                                         const void* weight, const void* bias, void* part,
                                         int bf16, int param_bf16, int R, int C, int vec,
                                         int spans, int row_blocks, int rows_per_block, float n,
                                         float eps, int act, void* stream) {
  if (bad_geometry(R, C, vec, spans, row_blocks, rows_per_block) || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(spans, row_blocks);
  const float* sm = static_cast<const float*>(sums);
  float* p = static_cast<float*>(part);
#define BN_BWD_STATS(T, V)                                                               \
  bn_train_bwd_stats<T, V><<<grid, THREADS, 0, s>>>(                                     \
      static_cast<const T*>(dy), static_cast<const T*>(x), sm, weight, bias, param_bf16, p, \
      R, C, rows_per_block, n, eps, act)
  if (bf16 && vec == 8) BN_BWD_STATS(__nv_bfloat16, 8);
  else if (bf16 && vec == 1) BN_BWD_STATS(__nv_bfloat16, 1);
  else if (!bf16 && vec == 4) BN_BWD_STATS(float, 4);
  else if (!bf16 && vec == 1) BN_BWD_STATS(float, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef BN_BWD_STATS
  return static_cast<int>(cudaGetLastError());
}

// gsums: the [2C] sums of dy * act' and dy * act' * (x - m) over every rank.
extern "C" int bn_train_bwd_dx_launch(const void* dy, const void* x, const void* sums,
                                      const void* gsums, const void* weight, const void* bias,
                                      void* dx, int bf16, int param_bf16, int R, int C, int vec,
                                      int spans, int row_blocks, int rows_per_block, float n,
                                      float eps, int act, void* stream) {
  if (bad_geometry(R, C, vec, spans, row_blocks, rows_per_block) || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(spans, row_blocks);
  const float* sm = static_cast<const float*>(sums);
  const float* gs = static_cast<const float*>(gsums);
#define BN_DX(T, V)                                                                        \
  bn_train_bwd_dx<T, V><<<grid, THREADS, 0, s>>>(                                          \
      static_cast<const T*>(dy), static_cast<const T*>(x), sm, gs, weight, bias, param_bf16, \
      static_cast<T*>(dx), R, C, rows_per_block, n, eps, act)
  if (bf16 && vec == 8) BN_DX(__nv_bfloat16, 8);
  else if (bf16 && vec == 1) BN_DX(__nv_bfloat16, 1);
  else if (!bf16 && vec == 4) BN_DX(float, 4);
  else if (!bf16 && vec == 1) BN_DX(float, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef BN_DX
  return static_cast<int>(cudaGetLastError());
}
