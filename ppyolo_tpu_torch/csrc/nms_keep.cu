// K6: the greedy keep of multiclass (hard) NMS for Hopper (sm_90a), from the
// candidates' boxes.
//
// Replaces the lax.while_loop fixpoint of
// ppyolo_tpu/ops/matrix_nms.py::_multiclass_nms_single, together with the
// [k, k] suppress matrix it iterates over.  No Pallas kernel stands behind it:
// XLA runs that loop in the JAX package.  The keep is the unique fixpoint of
//     keep[i] = valid[i] and not exists j < i: keep[j] and S[j][i],
//     S[j][i] = IoU(box j, box i) > thr and label[j] == label[i],
// i.e. the sequential greedy walk over the candidates in score order.  The
// JAX package iterates the whole-vector update to its fixpoint; on the card
// that loop's trip count depends on the data, which a CUDA graph cannot hold.
//
// What bounds it: the bytes are the candidates (16 B of box, 4 of label, 1 of
// valid) and the keep flags, 0.1 MB at b8, k = 500, and the operations the
// IoUs the walk needs (at most k(k-1)/2 an image, ~12 flops each): both well
// under a microsecond.  What sets its time is the walk's dependent chain, one
// round a chunk of 32 candidates, run by one SM an image.  The first form of
// K6 read a [B, k, k] bool matrix that ~15 eager kernels had built from a
// [B, k, k] fp32 IoU, and capped k at 1024.  This form never stores anything
// O(k^2):
//
// * One block per image (the walk is sequential within an image).  The
//   candidates go to shared memory once: box, area, label, and two 32-bit
//   masks a candidate (below), 32 B and 3 bits a candidate, 16 KB at k = 500.
//   Where they do not fit (k past ~7,000), the same layout lives in a global
//   scratch buffer the wrapper allocates (served from L2).  k is bounded only
//   by int32 indexing.
// * Chunks of 32 candidates, one bit a candidate in a 32-bit word.  First the
//   warps build, in parallel, each candidate's mask of the earlier candidates
//   of its own chunk that suppress it ("diag") and of the chunk before's
//   ("prev"): the only pairs on the walk's critical path.
// * Then one round a chunk, one __syncthreads() a round (16 at k = 500).  In
//   round r one warp resolves chunk r: lane l is alive if valid, not removed,
//   and not suppressed by a kept candidate of chunk r-1 (its prev mask AND
//   that chunk's kept word); a shuffle walk over the 32 lanes then keeps lane
//   l if it is alive and no kept lane before it is in its diag mask.  In the
//   same round the other warps test the candidates of the later chunks
//   (r+1 ...) against chunk r-1's kept boxes, one lane a candidate, and OR a
//   ballot of the hits into that chunk's "removed" word.  A chunk's kept
//   boxes split into shares over the warps where the later chunks are fewer
//   than the warps, the shares' hits meeting by a shared-memory atomicOr, so
//   the last rounds, with few chunks left, do not wait on one warp.
// * A lane tests four candidates at a time, their loads and label compares
//   independent (one at a time, the loop is a latency chain), and an IoU
//   runs only where some lane's candidate has the label and, for a threshold
//   >= 0, a box that overlaps (a few compares; the division is rare then).
// * Bit-exact IoU: every step rounds on its own (__fsub_rn, __fmul_rn,
//   __fadd_rn, __fdiv_rn: no FMA contraction) in the order of
//   ops/iou.py::pairwise_iou, compared with the threshold as an fp32, so the
//   keep flags equal the plain version's (nms_keep_boxes_plain: the eager
//   matrix and the fixpoint).
//
// Layouts: valid [B, k] bytes (torch bool), boxes [B, k, 4] fp32 xyxy (16-byte
// aligned), labels [B, k] int32, keep [B, k] bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;     // candidates a lane tests against at a time
constexpr int SMEM_MAX = 232448;  // 227 KB: the most a block may opt in to

// Bytes of one image's candidates: box, area, label, diag and prev masks,
// then the valid, removed and kept words.
__host__ __device__ size_t image_bytes(int k) {
  const size_t words = ((size_t)k + 31) / 32;
  return ((size_t)k * 32 + words * 12 + 15) / 16 * 16;
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// pairwise_iou(a, b, eps=1e-9) > thr, each op rounded as torch rounds it
// (no FMA contraction: union = (area_a + area_b) - inter, then + eps, then
// a true division), so the decision is torch's.  torch's min, max and clamp
// keep a NaN where fminf and fmaxf drop it; they differ only where a
// coordinate is NaN, or where a box spans inf - inf, and then that box's
// area is NaN, so is the IoU, and both decisions are false.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-9f)) > thr;
}

// Whether j may suppress i, before any IoU: only a candidate of its label,
// and for thr >= 0 only one whose box overlaps by a positive area (otherwise
// w or h clamps to 0, inter = 0 and 0 / d is 0 or NaN, not above thr; a NaN
// fails these compares as its IoU fails the threshold).
__device__ __forceinline__ bool may_suppress(float4 a, int la, float4 b, int lb, float thr) {
  return la == lb && (thr < 0.f || (fminf(a.z, b.z) > fmaxf(a.x, b.x) &&
                                    fminf(a.w, b.w) > fmaxf(a.y, b.y)));
}

// Warp-collective.  Each lane's candidate (bi, ai, li) where `open`, and the
// candidates j0 + m, m a set bit of `bits`, m < `below` (its lane, in its own
// chunk; 32 otherwise): the m that suppress the lane's candidate, as bits.
// FIRST: stop a lane at its first suppressor, and the warp once every lane
// has one.  GROUP candidates at a time, their loads and tests independent of
// each other (the loop is a latency chain otherwise); an IoU runs only where
// some lane passes may_suppress, so the pairs of other labels and of boxes
// apart cost the warp a few compares.
template <bool FIRST>
__device__ __forceinline__ uint32_t suppressors(uint32_t bits, int j0, bool open, int below,
                                                float4 bi, float ai, int li, const float4* box,
                                                const float* area, const int* lab, float thr) {
  uint32_t out = 0u;
  while (bits != 0u) {
    int m[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      m[u] = bits != 0u ? __ffs(bits) - 1 : 32;
      bits &= bits - 1u;
    }
    const bool want = open && !(FIRST && out != 0u);
    bool need[GROUP], any = false;
    float4 bj[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int j = j0 + (m[u] < 32 ? m[u] : 0);
      bj[u] = box[j];
      need[u] = want && m[u] < below && may_suppress(bj[u], lab[j], bi, li, thr);
      any |= need[u];
    }
    if (__any_sync(FULL, any)) {
#pragma unroll
      for (int u = 0; u < GROUP; ++u)
        if (need[u] && iou_above(bj[u], area[j0 + m[u]], bi, ai, thr)) out |= 1u << m[u];
    }
    if (FIRST && !__any_sync(FULL, open && out == 0u)) break;
  }
  return out;
}

template <bool IN_SMEM>
__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const uint8_t* __restrict__ valid, const float4* __restrict__ boxes,
                const int* __restrict__ labels, float thr, uint8_t* __restrict__ keep, int k,
                unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ws = IN_SMEM ? smem : scratch + blockIdx.x * image_bytes(k);
  const int words = (k + 31) / 32;
  float4* const box = reinterpret_cast<float4*>(ws);
  float* const area = reinterpret_cast<float*>(box + k);
  int* const lab = reinterpret_cast<int*>(area + k);
  uint32_t* const diag = reinterpret_cast<uint32_t*>(lab + k);  // earlier lanes of its chunk
  uint32_t* const prev = diag + k;                              // lanes of the chunk before
  uint32_t* const vbits = prev + k;                             // [words]
  uint32_t* const removed = vbits + words;                      // [words], by far updates
  uint32_t* const kept = removed + words;                       // [words]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t base = (size_t)blockIdx.x * k;

  for (int i = threadIdx.x; i < k; i += THREADS) {
    const float4 b = __ldg(boxes + base + i);
    box[i] = b;
    area[i] = area_of(b);
    lab[i] = __ldg(labels + base + i);
  }
  for (int w = warp; w < words; w += WARPS) {
    const int i = 32 * w + lane;
    const uint32_t v = __ballot_sync(FULL, i < k && valid[base + i] != 0);
    if (lane == 0) {
      vbits[w] = v;
      removed[w] = 0u;
    }
  }
  __syncthreads();

  // The pairs on the walk's critical path: each candidate's suppressors in
  // its own chunk (item 2c) and in the chunk before (item 2c + 1).
  for (int item = warp; item < 2 * words; item += WARPS) {
    const int c = item / 2, i = 32 * c + lane;
    const bool open = i < k && ((vbits[c] >> lane) & 1u);
    const int ic = open ? i : 0;
    if (item % 2 == 0) {
      const uint32_t dm = suppressors<false>(vbits[c], 32 * c, open, lane, box[ic], area[ic],
                                             lab[ic], box, area, lab, thr);
      if (i < k) diag[i] = dm;
    } else {
      const uint32_t pm = c == 0 ? 0u : suppressors<false>(vbits[c - 1], 32 * (c - 1), open, 32,
                                                           box[ic], area[ic], lab[ic], box,
                                                           area, lab, thr);
      if (i < k) prev[i] = pm;
    }
  }
  __syncthreads();

  for (int r = 0; r < words; ++r) {
    const uint32_t kp = r > 0 ? kept[r - 1] : 0u;  // published before the last barrier
    const int resolver = r % WARPS;
    if (warp == resolver) {  // resolve chunk r
      const int i = 32 * r + lane;
      const bool alive = i < k && ((vbits[r] >> lane) & 1u) && !((removed[r] >> lane) & 1u) &&
                         !(prev[i] & kp);
      const uint32_t al = __ballot_sync(FULL, alive);
      const uint32_t col = i < k ? diag[i] : 0u;
      uint32_t kb = 0u;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const uint32_t cl = __shfl_sync(FULL, col, l);
        if (((al >> l) & 1u) && !(cl & kb)) kb |= 1u << l;
      }
      if (lane == 0) kept[r] = kb;
      if (i < k) keep[base + i] = (kb >> lane) & 1u;
    }
    if (kp != 0u) {
      // Chunk r-1's kept boxes against the candidates of every later chunk,
      // in items of (chunk w, the g-th share of those boxes) over the warps,
      // the resolver's last.  Where the later chunks are fewer than the
      // warps, the kept boxes split into shares (of GROUP or more) so every
      // warp has an item; a word's hits from several warps meet by an
      // atomicOr in shared memory (a removed bit read stale costs an IoU,
      // never a flag).
      const int j0 = 32 * (r - 1), nk = __popc(kp), later = words - r - 1;
      const int shares = min((nk + GROUP - 1) / GROUP, max(1, WARPS / max(later, 1)));
      const int per = (nk + shares - 1) / shares;
      const int items = later * shares;
      const int rank = __popc(kp & ((1u << lane) - 1u));  // lane's place among the kept
      for (int item = (warp + WARPS - resolver - 1) % WARPS; item < items; item += WARPS) {
        const int w = r + 1 + item / shares, g = item % shares;
        const uint32_t sub = __ballot_sync(FULL, ((kp >> lane) & 1u) && rank / per == g);
        const int i = 32 * w + lane;
        const bool open = i < k && ((vbits[w] >> lane) & 1u) && !((removed[w] >> lane) & 1u);
        const int ic = open ? i : 0;
        const bool hit = suppressors<true>(sub, j0, open, 32, box[ic], area[ic], lab[ic], box,
                                           area, lab, thr) != 0u;
        const uint32_t hits = __ballot_sync(FULL, hit);
        if (lane == 0 && hits) atomicOr(removed + w, hits);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Bytes of global scratch the launch needs for B images of k candidates: 0
// where one image's candidates fit in shared memory.
extern "C" long long nms_keep_scratch_bytes(int B, int k) {
  const size_t per = image_bytes(k);
  return per <= (size_t)SMEM_MAX ? 0 : (long long)(per * (size_t)B);
}

// Returns the launch's CUDA error (0 on success).  scratch: nms_keep_scratch_bytes
// bytes (null where that is 0).
extern "C" int nms_keep_launch(const void* valid, const void* boxes, const void* labels,
                               void* keep, void* scratch, int B, int k, float thr,
                               void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      nms_keep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (B < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per = image_bytes(k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float4* bx = static_cast<const float4*>(boxes);
  const int* lb = static_cast<const int*>(labels);
  uint8_t* out = static_cast<uint8_t*>(keep);
  if (per <= (size_t)SMEM_MAX) {
    nms_keep_kernel<true><<<B, THREADS, per, s>>>(v, bx, lb, thr, out, k, nullptr);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    nms_keep_kernel<false><<<B, THREADS, 0, s>>>(v, bx, lb, thr, out, k,
                                                 static_cast<unsigned char*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
