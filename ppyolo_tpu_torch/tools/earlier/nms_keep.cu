// The first form of K6 (commit 76e2a95): the greedy keep over a [B, k, k] bool
// suppress matrix built eagerly beforehand.  Kept as tools/kernel_ab's baseline for K6.
//
// K6: the greedy keep of multiclass (hard) NMS for Hopper (sm_90a).
//
// Replaces the lax.while_loop fixpoint of
// ppyolo_tpu/ops/matrix_nms.py::_multiclass_nms_single.  No Pallas kernel
// stands behind it: XLA runs that loop in the JAX package.  The keep is the
// unique fixpoint of
//     keep[i] = valid[i] and not exists j < i: keep[j] and suppress[j][i],
// i.e. the sequential greedy walk over the candidates in score order.  The JAX
// package iterates the whole-vector (Jacobi) update to its fixpoint; on the card
// that loop's trip count depends on the data, which a CUDA graph cannot hold, and
// k fixed rounds of a [k, k] pass would cost k times the work.  So the walk runs
// in one block per image:
//
// * every warp turns rows of the [k, k] suppress matrix (bytes, computed by torch
//   exactly as the JAX package computes it) into 32-bit masks with __ballot_sync
//   (32 coalesced bytes per ballot, 8 loads in flight per warp) into shared
//   memory;
// * one warp then walks the candidates in order: lane l keeps word l of the
//   "suppressed" bitmask, candidate j is kept if it is valid and its bit is
//   clear (one shuffle), and a kept j ORs its row into the mask, each lane its
//   word.  The walk is k dependent steps of a few shared-memory cycles.
//
// Bound: the k x k matrix is read once (250 KB an image at k = 500); the walk is
// latency, not bytes.  k <= 1024 (32 mask words, one per lane).
//
// Layouts: valid [B, k] and suppress [B, k, k] as 0/1 bytes (torch bool), keep
// [B, k] bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_K = 1024;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const uint8_t* __restrict__ valid, const uint8_t* __restrict__ suppress,
                uint8_t* __restrict__ keep, int k) {
  extern __shared__ uint32_t smem[];
  const int words = (k + 31) / 32;
  uint32_t* rows = smem;                                        // [k][words]
  uint8_t* vbytes = reinterpret_cast<uint8_t*>(rows + k * words);  // [k]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const size_t b = blockIdx.x;
  const uint8_t* S = suppress + b * k * k;

  for (int j = threadIdx.x; j < k; j += blockDim.x) vbytes[j] = valid[b * k + j];
  const int items = k * words;
  for (int base = warp; base < items; base += UNROLL * nwarps) {
    bool s[UNROLL];  // UNROLL loads in flight before the ballots
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int item = base + u * nwarps;
      const int j = item / words, i = (item - j * words) * 32 + lane;
      s[u] = item < items && i < k && S[(size_t)j * k + i] != 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int item = base + u * nwarps;  // the same for every lane of the warp
      const uint32_t bits = __ballot_sync(0xffffffffu, s[u]);
      if (lane == 0 && item < items) rows[item] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  uint32_t removed = 0;  // lane l: bit (i % 32) of word l is set once a kept j suppressed i
  uint8_t* out = keep + b * k;
  for (int j = 0; j < k; ++j) {
    const uint32_t word = __shfl_sync(0xffffffffu, removed, j / 32);
    const bool kj = vbytes[j] != 0 && !((word >> (j % 32)) & 1u);
    if (kj && lane < words) removed |= rows[j * words + lane];
    if (lane == 0) out[j] = kj ? 1 : 0;
  }
}

size_t smem_bytes(int k) {
  return (size_t)k * ((k + 31) / 32) * 4 + (size_t)k;
}

}  // namespace

extern "C" int nms_keep_max_k() { return MAX_K; }

// Returns the launch's CUDA error (0 on success).
extern "C" int nms_keep_launch(const void* valid, const void* suppress, void* keep, int B, int k,
                               void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(MAX_K));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  nms_keep_kernel<<<B, THREADS, smem_bytes(k), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(suppress),
      static_cast<uint8_t*>(keep), k);
  return static_cast<int>(cudaGetLastError());
}
